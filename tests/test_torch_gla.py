"""gla_chunked through the port's kernel entry point: ``ops.gla`` (the
plain PyTorch version on CPU tensors) against the JAX ``ops.gla`` (the
Pallas kernel in interpret mode, as tests/test_kernels.py runs it), the
model stack's ``chunked_gla`` and the recurrent oracle ``ref.ref_gla``, on
the same numpy inputs; and the CUDA kernel against its plain version on a
card (``pytest -m cuda`` there; the module imports jax only inside the
tests that compare with it).

Tolerances: 2e-4, that of tests/test_kernels.py (float32 throughout; the
chunked and recurrent forms sum in other orders, and the port takes the
exclusive decay as the shifted cumulative sum where the reference
subtracts w again)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gla_chunk, ops, ref

TOL = 2e-4


def _inputs(bh, t, dk, dv, seed, *, strong=False):
    """q, k, v, w, u as float32 numpy arrays; w = -exp(N(0, 1)) as the
    JAX tests draw it, or with ``strong`` uniform in [-20, 0)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, t, dk)).astype(np.float32)
    k = rng.standard_normal((bh, t, dk)).astype(np.float32)
    v = rng.standard_normal((bh, t, dv)).astype(np.float32)
    if strong:
        w = -rng.uniform(0.0, 20.0, (bh, t, dk)).astype(np.float32)
    else:
        w = -np.exp(rng.standard_normal((bh, t, dk))).astype(np.float32)
    u = (rng.standard_normal((bh, dk)) * 0.3).astype(np.float32)
    return q, k, v, w, u


def _close(mine, theirs, tol=TOL):
    np.testing.assert_allclose(mine.float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("bh,t,dk,dv,chunk", [
    (2, 32, 8, 8, 8), (3, 64, 16, 8, 16), (1, 128, 32, 64, 32),
])
@pytest.mark.parametrize("mode", ["mamba", "rwkv"])
def test_gla_modes_match_jax(bh, t, dk, dv, chunk, mode):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    arrays = _inputs(bh, t, dk, dv, t + dk)
    jq, jk, jv, jw, ju = (jnp.asarray(a) for a in arrays)
    q, k, v, w, u = (torch.from_numpy(a) for a in arrays)
    inc = mode == "mamba"
    y, s = ops.gla(q, k, v, w, None if inc else u, chunk=chunk,
                   include_current=inc)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    assert y.shape == (bh, t, dv) and s.shape == (bh, dk, dv)
    yj, sj = jops.gla(jq, jk, jv, jw, None if inc else ju, chunk=chunk,
                      include_current=inc)
    _close(y, yj)
    _close(s, sj)
    yr, sr = jref.ref_gla(jq, jk, jv, jw, None if inc else ju,
                          include_current=inc)
    _close(y, yr)
    _close(s, sr)
    y2, s2 = ref.ref_gla(q, k, v, w, None if inc else u, include_current=inc)
    _close(y2, yr)
    _close(s2, sr)


def test_gla_matches_model_core():
    """As tests/test_kernels.py::test_gla_kernel_matches_model_core: the
    model stack's chunked_gla on [B, H, T, D] against ops.gla on [B*H, T,
    D]."""
    import jax.numpy as jnp
    from repro.models.linear_attention import chunked_gla
    b, h, t, d = 2, 3, 64, 16
    q, k, v, w, _ = _inputs(b * h, t, d, d, 0)
    y_model, s_model = chunked_gla(
        *(jnp.asarray(a.reshape(b, h, t, d)) for a in (q, k, v, w)),
        chunk=16, include_current=True)
    y, s = ops.gla(*(torch.from_numpy(a) for a in (q, k, v, w)), chunk=16,
                   include_current=True)
    _close(y.reshape(b, h, t, d), y_model)
    _close(s.reshape(b, h, d, d), s_model)


@pytest.mark.parametrize("inc", [True, False])
def test_strong_decay_stays_finite_and_exact(inc):
    """w down to -20 a step: within a 32-step chunk the cumulative decay
    passes -300, so exp(-lc) would overflow float32; the differences are
    formed first and the result matches the recurrence and JAX."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    arrays = _inputs(2, 64, 16, 16, 9, strong=True)
    assert float(np.cumsum(arrays[3][:, :32], 1).min()) < -88.0
    jq, jk, jv, jw, ju = (jnp.asarray(a) for a in arrays)
    q, k, v, w, u = (torch.from_numpy(a) for a in arrays)
    y, s = ops.gla(q, k, v, w, None if inc else u, chunk=32,
                   include_current=inc)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    yr, sr = jref.ref_gla(jq, jk, jv, jw, None if inc else ju,
                          include_current=inc)
    _close(y, yr)
    _close(s, sr)
    yj, sj = jops.gla(jq, jk, jv, jw, None if inc else ju, chunk=32,
                      include_current=inc)
    _close(y, yj)
    _close(s, sj)


def test_bonus_with_include_current_and_bfloat16():
    """u is added on the diagonal whenever it is given (the reference's
    has_bonus does not look at include_current); bfloat16 q, k, v give y in
    bfloat16 and the state in float32."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    arrays = _inputs(2, 32, 8, 8, 4)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays[:3])
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:3])
    w, u = (torch.from_numpy(a) for a in arrays[3:])
    y, s = ops.gla(q, k, v, w, u, chunk=8, include_current=True)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    yj, sj = jops.gla(jq, jk, jv, jnp.asarray(arrays[3]),
                      jnp.asarray(arrays[4]), chunk=8, include_current=True)
    _close(y, np.asarray(yj, np.float32), 2e-2)
    _close(s, sj)


def test_both_packages_reject_a_chunk_that_does_not_divide():
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    arrays = _inputs(1, 40, 8, 8, 1)
    with pytest.raises(AssertionError):
        jops.gla(*(jnp.asarray(a) for a in arrays[:4]), chunk=16)
    with pytest.raises(ValueError):
        ops.gla(*(torch.from_numpy(a) for a in arrays[:4]), chunk=16)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    q = torch.zeros(1, 256, 8)
    with pytest.raises(ValueError):          # chunk above 128
        gla_chunk._launch(q, q, q, q, None, chunk=256, include_current=True)
    wide = torch.zeros(1, 64, 72)
    with pytest.raises(ValueError):          # Dk above 64
        gla_chunk._launch(wide, wide, q[:, :64], wide, None, chunk=64,
                          include_current=True)
    with pytest.raises(ValueError):          # u of the wrong shape
        ops.gla(q, q, q, q, torch.zeros(2, 8), chunk=64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,t,dk,dv,chunk", [
    (2, 32, 8, 8, 8), (3, 64, 16, 8, 16), (1, 128, 32, 64, 32),
    (2, 256, 64, 64, 128), (2, 60, 6, 10, 12),   # padded dims, odd chunk
])
@pytest.mark.parametrize("mode", ["mamba", "rwkv", "mamba_bonus",
                                  "rwkv_strong"])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, bh, t, dk,
                                           dv, chunk, mode):
    arrays = _inputs(bh, t, dk, dv, t + dk, strong=mode.endswith("strong"))
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in arrays[:3])
    w, u = (torch.from_numpy(a).to(cuda_device) for a in arrays[3:])
    inc = mode.startswith("mamba")
    u = u if (not inc or mode == "mamba_bonus") else None
    before = gla_chunk.gla_chunked.launches
    y, s = ops.gla(q, k, v, w, u, chunk=chunk, include_current=inc)
    torch.cuda.synchronize()
    assert gla_chunk.gla_chunked.launches == before + 1
    assert y.dtype == dtype and s.dtype == torch.float32
    yp, sp = gla_chunk.gla_chunked_ref(q, k, v, w, u, chunk=chunk,
                                       include_current=inc)
    ytol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), yp.float(), rtol=ytol, atol=ytol)
    torch.testing.assert_close(s, sp, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The tensor-core route's sub-chunked factorisation, emulated on the CPU
# ---------------------------------------------------------------------------

def _bf16_inputs(bh, t, dk, dv, seed, **kw):
    """_inputs with q, k and v rounded to bf16 (kept as float32 numpy), the
    values the tensor-core route reads."""
    q, k, v, w, u = _inputs(bh, t, dk, dv, seed, **kw)
    r = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    return r(q), r(k), r(v), w, u


@pytest.mark.parametrize("bh,t,dk,dv,chunk", [
    (2, 64, 16, 16, 32), (1, 128, 32, 64, 64), (2, 96, 64, 32, 48),
])
@pytest.mark.parametrize("mode", ["mamba", "rwkv", "mamba_bonus",
                                  "rwkv_nobonus"])
def test_subchunk_factorisation_matches_jax(bh, t, dk, dv, chunk, mode):
    """torchhelp.emulate_gla_subchunks (sub-chunks of 16, hi + lo
    roundings) against JAX gla_chunked (Pallas, interpret mode) and
    ref_gla on the same bf16-valued inputs, within tests/test_kernels.py's
    2e-4, and against the port's plain version; both include_current
    forms, with and without u (ref_gla adds u only without
    include_current, so its y is not compared where both are set)."""
    import jax.numpy as jnp
    from repro.kernels import gla_chunk as jgla
    from repro.kernels import ref as jref
    from torchhelp import emulate_gla_subchunks
    arrays = _bf16_inputs(bh, t, dk, dv, t + dk + len(mode))
    inc = mode.startswith("mamba")
    bonus = mode in ("rwkv", "mamba_bonus")
    q, k, v, w, u = (torch.from_numpy(a) for a in arrays)
    jq, jk, jv, jw, ju = (jnp.asarray(a) for a in arrays)
    y, s = emulate_gla_subchunks(q, k, v, w, u if bonus else None,
                                 chunk=chunk, include_current=inc)
    yj, sj = jgla.gla_chunked(jq, jk, jv, jw, ju if bonus else None,
                              chunk=chunk, include_current=inc,
                              interpret=True)
    _close(y, yj)
    _close(s, sj)
    yr, sr = jref.ref_gla(jq, jk, jv, jw, ju if bonus else None,
                          include_current=inc)
    if not (inc and bonus):
        _close(y, yr)
    _close(s, sr)
    yp, sp = gla_chunk.gla_chunked_ref(q, k, v, w, u if bonus else None,
                                       chunk=chunk, include_current=inc)
    _close(y, yp)
    _close(s, sp)


@pytest.mark.parametrize("inc", [True, False])
def test_subchunks_stay_finite_where_decays_pass_88(inc):
    """Chunk 128 at RWKV6's decays w = -exp(N(0, 1)): the cumulative decay
    passes -88 within a chunk, so one reference point per chunk would
    overflow; each factor of the sub-chunked product stays at most 1 and
    the result matches the recurrence within 2e-4."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from torchhelp import emulate_gla_subchunks
    arrays = _bf16_inputs(2, 256, 64, 64, 21)
    lc = np.cumsum(arrays[3][:, :128], 1)
    assert float(lc.min()) < -88.0
    q, k, v, w, u = (torch.from_numpy(a) for a in arrays)
    y, s = emulate_gla_subchunks(q, k, v, w, None if inc else u, chunk=128,
                                 include_current=inc)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    yr, sr = jref.ref_gla(*(jnp.asarray(a) for a in arrays[:4]),
                          None if inc else jnp.asarray(arrays[4]),
                          include_current=inc)
    _close(y, yr)
    _close(s, sr)


def test_split_operands_pass_the_state_check_and_bf16_operands_do_not():
    """Why the route splits its float32 operands: with hi + lo the state
    holds the smoke's 1e-4 against the plain version; with bf16 operands
    alone it does not."""
    from torchhelp import emulate_gla_subchunks
    q, k, v, w, u = (torch.from_numpy(a)
                     for a in _bf16_inputs(4, 256, 64, 64, 5))
    kw = dict(chunk=128, include_current=False)
    _, sp = gla_chunk.gla_chunked_ref(q, k, v, w, u, **kw)
    _, s = emulate_gla_subchunks(q, k, v, w, u, **kw)
    _, s1 = emulate_gla_subchunks(q, k, v, w, u, split=False, **kw)
    assert torch.allclose(s, sp, rtol=1e-4, atol=1e-4)
    assert not torch.allclose(s1, sp, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,chunk,want", [
    (torch.bfloat16, 128, "tensor_core"), (torch.bfloat16, 16, "tensor_core"),
    (torch.bfloat16, 12, "cuda_core"), (torch.float32, 128, "cuda_core"),
])
def test_route(dtype, chunk, want):
    assert gla_chunk.route(dtype, chunk) == want


@pytest.mark.cuda
@pytest.mark.parametrize("inc,bonus", [(True, False), (False, True),
                                       (True, True), (False, False)])
def test_cuda_tensor_core_route_at_model_widths(cuda_device, inc, bonus):
    """The tensor-core route at chunk 128, Dk = Dv = 64, RWKV6-like decays,
    4 chunks: y within 2e-2 and the state within 1e-4 of the plain
    version (the smoke's tolerances), and as close to the emulated
    factorisation as float32 sums in another order allow."""
    from torchhelp import emulate_gla_subchunks
    arrays = _bf16_inputs(8, 512, 64, 64, 3)
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in arrays[:3])
    w, u = (torch.from_numpy(a).to(cuda_device) for a in arrays[3:])
    u = u if bonus else None
    assert gla_chunk.route(q.dtype, 128) == "tensor_core"
    y, s = ops.gla(q, k, v, w, u, chunk=128, include_current=inc)
    yp, sp = gla_chunk.gla_chunked_ref(q, k, v, w, u, chunk=128,
                                       include_current=inc)
    torch.testing.assert_close(y.float(), yp.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(s, sp, rtol=1e-4, atol=1e-4)
    ye, se = emulate_gla_subchunks(*(a.cpu() for a in (q, k, v, w)),
                                   None if u is None else u.cpu(),
                                   chunk=128, include_current=inc)
    torch.testing.assert_close(y.float().cpu(),
                               ye.to(torch.bfloat16).float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(s.cpu(), se, rtol=1e-4, atol=1e-4)
