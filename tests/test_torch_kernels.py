"""The port's kernel module against the JAX package's kernels.

On the CPU `repro_torch.kernels.ops` runs the plain versions (the CUDA
kernels are held against those same plain versions on the card by
`chip_smoke.py`).  Here the plain versions are held against the Pallas
kernels (interpret mode, as `tests/test_kernels.py` runs them) and the
JAX model path's jnp flash attention.  Inputs come from numpy.

Tolerances: 2e-2 in bf16 (as `tests/test_kernels.py`: one bf16 ulp of
an O(1) output, different summation order) and 2e-4 absolute / 1e-3
relative in f32.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.convert import to_torch
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops, ref
from repro_torch.kernels import split_matmul as tsplit
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import attention as tattn

DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-4, rtol=1e-3)


def _rand(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# --- split_matmul -----------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (128, 256, 64),
                                   (256, 384, 128), (64, 512, 256)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_matmul_matches_pallas(m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    x, w = _rand(rng, (m, k), dtype), _rand(rng, (k, n), dtype)
    want = jops.split_matmul(jnp.asarray(x), jnp.asarray(w), bm=64, bn=64,
                             bk=64, interpret=True)
    got = ops.split_matmul(to_torch(x, "cpu"), to_torch(w, "cpu"), bk=64)
    assert got.dtype == to_torch(x, "cpu").dtype
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **_tol(dtype))


@pytest.mark.parametrize("m,k,n", [(5, 37, 19), (8, 100, 130),
                                   (65, 33, 70), (1, 3072, 7)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_matmul_ragged_matches_numpy(m, k, n, dtype):
    """Ragged M, N, K (the Pallas kernel asserts divisibility)."""
    rng = np.random.default_rng(m * k + n)
    x, w = _rand(rng, (m, k), dtype), _rand(rng, (k, n), dtype)
    want = x.astype(np.float32) @ w.astype(np.float32)
    got = ops.split_matmul(to_torch(x, "cpu"), to_torch(w, "cpu"), bk=32)
    np.testing.assert_allclose(_np(got), want, **_tol(dtype))


def test_split_matmul_is_operator_splitting():
    """Slice granularity K/bk does not change the result (f32)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_rand(rng, (128, 512), "float32"))
    w = torch.from_numpy(_rand(rng, (512, 128), "float32"))
    outs = [ops.split_matmul(x, w, bk=bk) for bk in (512, 256, 128, 64, 37)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), atol=1e-4,
                                   rtol=1e-5)


# --- flash_attention --------------------------------------------------------

@pytest.mark.parametrize("shape", [
    # B, KV, G, S, T, hd
    (1, 1, 1, 64, 64, 32),
    (2, 2, 3, 128, 128, 32),
    (1, 4, 2, 64, 192, 64),     # cross lengths
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 17),
                                           (False, 0)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_matches_pallas(shape, causal, window, dtype):
    """Plain flash in the model layout vs the Pallas kernel in its own
    (B,KV,G,S,hd) layout; shapes divisible by the Pallas blocks."""
    B, KV, G, S, T, hd = shape
    rng = np.random.default_rng(sum(shape))
    q = _rand(rng, (B, S, KV, G, hd), dtype, 0.5)
    k = _rand(rng, (B, T, KV, hd), dtype, 0.5)
    v = _rand(rng, (B, T, KV, hd), dtype)
    want = jops.flash_attention(
        jnp.asarray(q.transpose(0, 2, 3, 1, 4)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), causal=causal, window=window,
        bq=32, bk=32, interpret=True)
    got = ops.flash_attention(to_torch(q, "cpu"), to_torch(k, "cpu"),
                              to_torch(v, "cpu"), causal=causal,
                              window=window)
    np.testing.assert_allclose(
        _np(got), np.asarray(want, np.float32).transpose(0, 3, 1, 2, 4),
        **_tol(dtype))


@pytest.mark.parametrize("S,T,q_offset", [(37, 37, 0), (20, 45, 25)])
@pytest.mark.parametrize("window", [0, 13, 17])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_matches_jax_model_path(S, T, q_offset, window, dtype):
    """Ragged S, sliding windows, G > 1, a query offset: the plain flash
    vs `repro.models.attention.flash_attention` (blocks 16 x 24 there,
    so its padding and multi-block carry are exercised) and vs the
    port's naive `attention_ref`."""
    B, KV, G, hd = 2, 2, 3, 32
    rng = np.random.default_rng(S * 7 + T + window)
    q = _rand(rng, (B, S, KV, G, hd), dtype, 0.5)
    k = _rand(rng, (B, T, KV, hd), dtype, 0.5)
    v = _rand(rng, (B, T, KV, hd), dtype)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, window=window,
                                 q_offset=q_offset, bq=16, bk=24)
    tq, tk, tv = (to_torch(a, "cpu") for a in (q, k, v))
    got = tattn.flash_attention(tq, tk, tv, causal=True, window=window,
                                q_offset=q_offset)
    naive = tattn.attention_ref(tq, tk, tv, causal=True, window=window,
                                q_offset=q_offset)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(naive), **_tol(dtype))


def test_attention_ref_matches_jax_oracle():
    rng = np.random.default_rng(3)
    q = _rand(rng, (1, 33, 2, 2, 16), "float32")
    k = _rand(rng, (1, 33, 2, 16), "float32")
    v = _rand(rng, (1, 33, 2, 16), "float32")
    want = jattn.attention_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, window=9)
    got = tattn.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-3)


# --- dispatch ---------------------------------------------------------------

KERNELS = ["split_matmul", "flash_attention", "ssd_scan", "ssd_scan_bwd"]
# every counter `ops.launch_counts` keeps, the backward kernels' too
NO_LAUNCHES = dict.fromkeys(KERNELS + ["split_matmul_acc",
                                       "split_matmul_dgrad",
                                       "split_matmul_wgrad",
                                       "flash_attention_bwd"], 0)


def _dispatch_case(name, rng):
    """(ops call, plain version) on the same CPU tensors."""
    f = lambda shape: torch.from_numpy(_rand(rng, shape, "float32"))
    if name == "split_matmul":
        x, w = f((8, 40)), f((40, 24))
        return ops.split_matmul(x, w), ref.split_matmul_ref(x, w)
    if name == "flash_attention":
        q, k = f((1, 9, 1, 2, 16)), f((1, 9, 1, 16))
        return (ops.flash_attention(q, k, k, causal=True),
                ref.flash_attention_ref(q, k, k, causal=True))
    args = (f((2, 21, 3, 8)), f((2, 21, 3)).abs(), f((3,)).abs(),
            f((2, 21, 4)), f((2, 21, 4)))
    s0 = f((2, 3, 8, 4))
    if name == "ssd_scan_bwd":
        kw = dict(chunk=8, d_final_state=f((2, 3, 8, 4)), init_state=s0)
        dy = f((2, 21, 3, 8))
        return (ops.ssd_scan_bwd(*args, dy, **kw),
                ref.ssd_scan_bwd_ref(*args, dy, **kw))
    return (ops.ssd_scan(*args, chunk=8, init_state=s0),
            ref.ssd_scan_ref(*args, chunk=8, init_state=s0))


@pytest.mark.parametrize("name", KERNELS)
def test_ops_take_plain_versions_on_cpu(name):
    ops.reset_launch_counts()
    got, want = _dispatch_case(name, np.random.default_rng(1))
    torch.testing.assert_close(got, want)
    assert ops.launch_counts() == NO_LAUNCHES


def _wrapper_call(name, dev="cpu"):
    """The CUDA wrapper (or, with dev="meta", `ops` on mixed devices)
    on tensors of the CPU."""
    z = lambda *shape, d="cpu": torch.zeros(*shape, device=d)
    if name == "split_matmul":
        if dev == "meta":
            return lambda: ops.split_matmul(z(4, 4), z(4, 4, d="meta"))
        return lambda: tsplit.split_matmul(z(4, 4), z(4, 4))
    if name == "flash_attention":
        fn = ops.flash_attention if dev == "meta" else tflash.flash_attention
        return lambda: fn(z(1, 4, 1, 1, 64), z(1, 4, 1, 64, d=dev),
                          z(1, 4, 1, 64), causal=True)
    if name == "ssd_scan_bwd":
        fn = ops.ssd_scan_bwd if dev == "meta" else tssd.ssd_scan_bwd
        return lambda: fn(z(1, 4, 2, 8), z(1, 4, 2), z(2), z(1, 4, 4, d=dev),
                          z(1, 4, 4), z(1, 4, 2, 8), chunk=4)
    fn = ops.ssd_scan if dev == "meta" else tssd.ssd_scan
    return lambda: fn(z(1, 4, 2, 8), z(1, 4, 2), z(2), z(1, 4, 4, d=dev),
                      z(1, 4, 4), chunk=4)


@pytest.mark.parametrize("name", KERNELS)
def test_cuda_wrappers_refuse_cpu_tensors(name):
    """The kernel wrappers never compute on the CPU: no fallback; `ops`
    refuses inputs on two devices."""
    with pytest.raises(ValueError, match="CUDA"):
        _wrapper_call(name)()
    with pytest.raises(ValueError, match="all on the CPU"):
        _wrapper_call(name, "meta")()
    assert ops.launch_counts() == NO_LAUNCHES


def test_bf16_conversion_is_bit_exact():
    a = (np.random.default_rng(0).standard_normal((3, 5))
         .astype(ml_dtypes.bfloat16))
    t = to_torch(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
