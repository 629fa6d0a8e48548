"""flash_attention through the port's kernel entry point: ``ops.attention``
(the plain PyTorch version on CPU tensors) against the JAX package's
``ref.ref_attention`` on the same numpy inputs, and the CUDA kernel
against its plain version on a card (``pytest -m cuda`` there; the module
imports jax only inside the tests that compare with it).  The reference
is ``ref_attention``, not the Pallas kernel: on jax 0.9 the kernel raises
before it runs (``pl.load``), for every shape it accepts.

Tolerances: 1e-5 for float32 and 2e-2 for bfloat16, those of
tests/test_kernels.py (bfloat16: the output is rounded to 8 bits of
mantissa, and the two packages may round a value either side of a
boundary).  The tensor-core route's cases hold it to chip_smoke.py's bf16
check, rtol 2e-2 / atol 1e-3, with q and k at variance 40 so the scores
reach the softcap; the CPU tests of its roundings show why P·V takes P as
two bf16 terms."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from torchhelp import emulate_attention_roundings

BF16_RTOL, BF16_ATOL = 2e-2, 1e-3       # chip_smoke.py's bf16 check
SCORE_VAR = 40.0                        # q, k variance: scores of std 40


def _inputs(bh, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((bh, s, d)).astype(np.float32)
                 for s in (sq, skv, skv))


def _both(arrays, dtype):
    """The same values as jax and torch arrays of ``dtype``; bfloat16 is
    rounded from float32 to nearest even by both."""
    import jax.numpy as jnp
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _compare(mine, theirs, tol):
    np.testing.assert_allclose(mine.float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("bh,sq,skv,d", [
    (2, 64, 64, 16), (1, 128, 128, 32), (4, 64, 64, 8), (2, 256, 256, 16),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_shapes_dtypes_match_jax(bh, sq, skv, d, dtype):
    from repro.kernels import ref as jref
    (jq, jk, jv), (q, k, v) = _both(_inputs(bh, sq, skv, d, bh * sq + d),
                                    dtype)
    o = ops.attention(q, k, v, causal=True)
    assert o.dtype == q.dtype and o.shape == q.shape
    _compare(o, jref.ref_attention(jq, jk, jv, causal=True),
             1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 32, 0.0), (False, 0, 0.0), (True, 0, 50.0),
    (True, 16, 30.0),
])
def test_attention_masks_and_softcap_match_jax(causal, window, softcap):
    from repro.kernels import ref as jref
    (jq, jk, jv), (q, k, v) = _both(_inputs(2, 128, 128, 16, 5), "float32")
    o = ops.attention(q, k, v, causal=causal, window=window, softcap=softcap)
    _compare(o, jref.ref_attention(jq, jk, jv, causal=causal, window=window,
                                   softcap=softcap), 1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_rows_with_no_valid_key_are_the_mean_of_v(causal):
    """Sq > Skv with a small window: query positions from Skv + window - 1
    on see no key (positions count from 0 for both), and -1e30 fills make
    them the mean of v, as in the JAX reference."""
    from repro.kernels import ref as jref
    sq, skv, window = 256, 128, 16
    (jq, jk, jv), (q, k, v) = _both(_inputs(2, sq, skv, 32, 11), "float32")
    o = ops.attention(q, k, v, causal=causal, window=window, softcap=20.0)
    _compare(o, jref.ref_attention(jq, jk, jv, causal=causal, window=window,
                                   softcap=20.0), 1e-5)
    empty = skv + window - 1
    torch.testing.assert_close(
        o[:, empty:], v.mean(1, keepdim=True).expand(-1, sq - empty, -1),
        rtol=1e-5, atol=1e-5)
    assert torch.isfinite(o).all()


def test_plain_version_matches_port_oracle_with_fewer_queries():
    """Sq < Skv, causal: the diagonal starts at key 0, not end-aligned."""
    (q, k, v) = (torch.from_numpy(a) for a in _inputs(3, 64, 256, 8, 2))
    for causal, window in ((True, 0), (True, 40), (False, 100)):
        torch.testing.assert_close(
            ops.attention(q, k, v, causal=causal, window=window),
            ref.ref_attention(q, k, v, causal=causal, window=window),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq,skv", [(192, 128), (128, 320)])
def test_both_packages_reject_blocks_that_do_not_divide(sq, skv):
    from repro.kernels import ops as jops
    (jq, jk, jv), (q, k, v) = _both(_inputs(1, sq, skv, 16, 0), "float32")
    with pytest.raises(AssertionError):
        jops.attention(jq, jk, jv)
    with pytest.raises(ValueError):
        ops.attention(q, k, v)
    with pytest.raises(ValueError):
        fa.flash_attention_ref(q, k, v)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    q = torch.zeros(1, 64, 24)
    with pytest.raises(ValueError):          # head dim 24 is not built
        fa._launch(q, q, q, causal=True, window=0, softcap=0.0)
    with pytest.raises(ValueError):          # k and v of another shape
        ops.attention(q, torch.zeros(1, 64, 16), torch.zeros(1, 64, 16))
    with pytest.raises(ValueError):
        ops.attention(q, q, q, window=-1)


def _gemma_like(bh, sq, skv, d, seed, v_max=None):
    """bf16 q and k at variance 40 (scaled scores of std ~40, as the
    smoke's Gemma2-9B inputs) and v ~ N(0, 1), or scaled to a largest
    magnitude of ``v_max``."""
    rng = np.random.default_rng(seed)
    q, k = (np.sqrt(SCORE_VAR) * rng.standard_normal((bh, s, d))
            for s in (sq, skv))
    v = rng.standard_normal((bh, skv, d))
    if v_max is not None:
        v *= v_max / np.abs(v).max()
    return tuple(torch.from_numpy(a.astype(np.float32)).bfloat16()
                 for a in (q, k, v))


def _outside(out, want, atol=BF16_ATOL):
    """How many outputs fall outside rtol 2e-2 / ``atol`` of ``want``."""
    out, want = out.float(), want.float()
    return int(((out - want).abs() > atol + BF16_RTOL * want.abs()).sum())


@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 50.0), (True, 0, 0.0), (True, 128, 50.0),
])
def test_split_p_passes_the_bf16_check_and_bf16_p_does_not(causal, window,
                                                          softcap):
    """D = 256, 512 positions, q and k at variance 40: P·V with P as
    bf16(p) + bf16(p - bf16(p)) (the tensor-core kernel's scheme) stays
    within rtol 2e-2 / atol 1e-3 of the plain version everywhere (with the
    softcap's tanh in the kernel's float32 exp form), while P rounded to
    bf16 once puts outputs outside."""
    q, k, v = _gemma_like(2, 512, 512, 256, 7)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = fa.flash_attention_ref(q, k, v, **kw)
    split = emulate_attention_roundings(q, k, v, **kw, pv="split",
                                        tanh="exp_form")
    assert _outside(split, want) == 0
    assert _outside(emulate_attention_roundings(q, k, v, **kw, pv="bf16"),
                    want) > 0


def test_route_follows_type_and_head_dim():
    for d in fa.KERNEL_HEAD_DIMS:
        assert fa.route(torch.float32, d) == "cuda_core"
        assert fa.route(torch.bfloat16, d) == (
            "tensor_core" if d in (64, 128, 256) else "cuda_core")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,causal,window,softcap", [
    (128, 128, True, 0, 0.0), (256, 256, True, 40, 50.0),
    (64, 96, False, 0, 30.0),          # a key count that is not 64-aligned
    (256, 128, True, 16, 0.0),         # rows with no valid key
    (64, 256, True, 0, 0.0),           # fewer queries than keys
])
def test_cuda_kernel_matches_plain_version(cuda_device, d, dtype, sq, skv,
                                           causal, window, softcap):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _inputs(2, sq, skv, d, d + sq))
    before = fa.flash_attention.launches
    o = ops.attention(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert o.dtype == dtype and o.shape == q.shape
    plain = fa.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), plain.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("bh,sq,skv,causal,window,softcap", [
    (2, 96, 96, True, 0, 0.0),           # ragged: not a multiple of 64
    (2, 384, 384, True, 0, 50.0),
    (1, 1024, 1024, True, 0, 0.0),
    (2, 128, 384, True, 0, 0.0),         # fewer queries than keys
    (2, 256, 128, True, 16, 20.0),       # rows with no valid key
    (2, 1024, 1024, True, 200, 50.0),    # window with softcap
    (3, 384, 384, False, 0, 30.0),       # bh = 3, no causal mask
])
def test_tensor_core_route_matches_plain_version(cuda_device, d, bh, sq, skv,
                                                 causal, window, softcap):
    assert fa.route(torch.bfloat16, d) == "tensor_core"
    q, k, v = (a.to(cuda_device) for a in _gemma_like(bh, sq, skv, d, d + sq))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = fa.flash_attention.launches
    o = ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert torch.isfinite(o).all()
    assert _outside(o, fa.flash_attention_ref(q, k, v, **kw)) == 0
    if window and sq >= skv + window - 1:
        empty = skv + window - 1
        assert _outside(o[:, empty:], v.float().mean(1, keepdim=True).expand(
            -1, sq - empty, -1)) == 0
    again = ops.attention(q, k, v, **kw)
    assert torch.equal(again, o)         # two calls are bit-equal


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_tensor_core_route_takes_large_v(cuda_device, d):
    """bf16 v up to 1e5 (past fp16's 65,504): finite, and within rtol 2e-2
    of the plain version with atol 1e-3 scaled by max |v| (the output is
    linear in v)."""
    q, k, v = (a.to(cuda_device) for a in _gemma_like(2, 384, 384, d, 3,
                                                      v_max=1e5))
    kw = dict(causal=True, window=0, softcap=50.0)
    o = ops.attention(q, k, v, **kw)
    assert torch.isfinite(o).all()
    assert _outside(o, fa.flash_attention_ref(q, k, v, **kw),
                    atol=BF16_ATOL * float(v.float().abs().max())) == 0
