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
boundary)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref


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
