"""The port's attention against the JAX package's, on the CPU.

On the CPU ``ops.attention(mode="pallas")`` takes the kernel's plain
version (``ref.flash_attention``); it and the port's ``chunked_attention``
are held against the JAX Pallas kernel in interpret mode and against
``repro.kernels.ref.flash_attention``, over the sweep of
``tests/test_kernels.py::TestFlashAttention``, on the same numpy inputs.
Tolerances as there: rtol/atol 2e-3 in f32 and 5e-2 in bf16 (the two sum
in different orders, and bf16 rounds the output).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

F32, BF16 = 2e-3, 5e-2


def _inputs(b, hq, hkv, s, d, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    return [r.normal(size=(b, h, s, d)).astype(dtype) for h in (hq, hkv, hkv)]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(dtype) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 2, 1, 128, 64), (2, 4, 2, 256, 32), (1, 8, 2, 128, 128), (1, 1, 1, 512, 64),
])
@pytest.mark.parametrize("causal", [True, False])
def test_sweep_shapes_match_pallas(b, hq, hkv, s, d, causal):
    arrays = _inputs(b, hq, hkv, s, d, seed=b * s + hq)
    q, k, v = (jnp.asarray(a) for a in arrays)
    want = jops.attention(q, k, v, causal=causal, mode="pallas", interpret=True)
    oracle = jref.flash_attention(q, k, v, causal=causal)
    tq, tk, tv = _torch(arrays)
    for mode in ("pallas", "chunked"):
        got = ops.attention(tq, tk, tv, causal=causal, mode=mode)
        assert got.dtype == torch.float32 and got.shape == tq.shape
        _close(got, want, F32)
        _close(got, oracle, F32)


@pytest.mark.parametrize("window", [64, 128])
def test_sliding_window_matches_pallas(window):
    arrays = _inputs(1, 2, 1, 256, 32, seed=3)
    q, k, v = (jnp.asarray(a) for a in arrays)
    want = jops.attention(q, k, v, causal=True, window=window, mode="pallas", interpret=True)
    tq, tk, tv = _torch(arrays)
    for mode in ("pallas", "chunked"):
        _close(ops.attention(tq, tk, tv, causal=True, window=window, mode=mode), want, F32)
    _close(ref.flash_attention(tq, tk, tv, window=window),
           jref.flash_attention(q, k, v, causal=True, window=window), F32)


def test_bf16_matches_pallas():
    arrays = _inputs(1, 4, 4, 128, 64, seed=4)
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    want = jops.attention(q, k, v, mode="pallas", interpret=True)
    tq, tk, tv = _torch([np.asarray(x, np.float32) for x in (q, k, v)], torch.bfloat16)
    for mode in ("pallas", "chunked"):
        got = ops.attention(tq, tk, tv, mode=mode)
        assert got.dtype == torch.bfloat16
        _close(got.float(), np.asarray(want, np.float32), BF16)


def test_chunked_matches_ref_across_blocks():
    """Four kv blocks of 64 (the JAX test's block size) and a ragged S."""
    arrays = _inputs(2, 4, 2, 256, 64, seed=5)
    q, k, v = (jnp.asarray(a) for a in arrays)
    want = jref.flash_attention(q, k, v, causal=True)
    tq, tk, tv = _torch(arrays)
    _close(ops.chunked_attention(tq, tk, tv, causal=True, block_k=64), want, 2e-4)
    want = jref.flash_attention(q[:, :, :200], k[:, :, :200], v[:, :, :200], causal=True)
    got = ops.chunked_attention(tq[:, :, :200], tk[:, :, :200], tv[:, :, :200], causal=True,
                                block_k=64)
    _close(got, want, 2e-4)


@pytest.mark.parametrize("s,window,causal,scale", [
    (1, None, True, None), (77, None, True, None), (77, 16, False, 0.3), (200, 64, True, None),
])
def test_plain_version_at_ragged_lengths(s, window, causal, scale):
    """The kernel's plain version at lengths the Pallas kernel does not
    take, against the JAX oracle (every row keeps at least one key)."""
    arrays = _inputs(1, 6, 1, s, 32, seed=s)
    q, k, v = (jnp.asarray(a) for a in arrays)
    want = jref.flash_attention(q, k, v, causal=causal, window=window, sm_scale=scale)
    got = ops.flash_attention(*_torch(arrays), causal=causal, window=window, sm_scale=scale)
    _close(got, want, F32)


def test_fully_masked_rows_give_zero():
    """A row with every key masked (a window of −1 here) outputs 0, as the
    Pallas body's l = 0 → 1 makes it; the JAX oracle gives NaN there."""
    q, k, v = _torch(_inputs(1, 2, 1, 8, 32, seed=9))
    out = ref.flash_attention(q, k, v, causal=True, window=-1)
    assert torch.equal(out, torch.zeros_like(out))


def test_decode_attention_matches_jax():
    arrays = _inputs(2, 6, 2, 40, 32, seed=6)
    q1 = arrays[0][:, :, :1]
    for cache_len in (1, 17, 40):
        want = jref.decode_attention(jnp.asarray(q1), jnp.asarray(arrays[1]),
                                     jnp.asarray(arrays[2]), cache_len)
        got = ops.decode_attention(*_torch([q1, arrays[1], arrays[2]]), cache_len)
        _close(got, want, 1e-5)
    lens = np.array([3, 40], np.int32)  # one length per batch row
    want = jref.decode_attention(jnp.asarray(q1), jnp.asarray(arrays[1]),
                                 jnp.asarray(arrays[2]), jnp.asarray(lens))
    got = ops.decode_attention(*_torch([q1, arrays[1], arrays[2]]), torch.from_numpy(lens))
    _close(got, want, 1e-5)


def test_decode_attention_bf16_matches_jax():
    arrays = [a.astype(ml_dtypes.bfloat16) for a in _inputs(1, 4, 2, 24, 64, seed=8)]
    q1 = arrays[0][:, :, :1]
    want = jref.decode_attention(*(jnp.asarray(a) for a in (q1, arrays[1], arrays[2])), 20)
    got = ops.decode_attention(*_torch([q1, arrays[1], arrays[2]], torch.bfloat16), 20)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), BF16)


def test_decode_matches_full_forward_last_token():
    q, k, v = _torch(_inputs(2, 4, 2, 64, 32, seed=7))
    full = ops.attention(q, k, v, causal=True, mode="pallas")
    dec = ops.decode_attention(q[:, :, -1:], k, v, cache_len=64)
    _close(dec[:, :, 0], full[:, :, -1], 1e-4)


def test_cpu_attention_counts_no_launch():
    q, k, v = _torch(_inputs(1, 2, 1, 16, 32, seed=1))
    before = ops.LAUNCHES["flash_attention"]
    ops.attention(q, k, v, mode="pallas")
    assert ops.LAUNCHES["flash_attention"] == before


def test_attention_rejects_a_device_mix():
    q, k, v = _torch(_inputs(1, 2, 1, 16, 32, seed=1))
    with pytest.raises(ValueError, match="several devices"):
        ops.flash_attention(q, k.to("meta"), v)


def test_attention_mode_may_be_a_function():
    """A function as ``mode`` is called as the kernel is, with the
    block's causal flag, window and scale."""
    tq, tk, tv = _torch(_inputs(1, 4, 2, 64, 32, seed=11))
    seen = []

    def mine(q, k, v, *, causal, window, sm_scale):
        seen.append((causal, window, sm_scale))
        return ref.flash_attention(q, k, v, causal=causal, window=window, sm_scale=sm_scale)

    got = ops.attention(tq, tk, tv, causal=False, window=16, sm_scale=0.2, mode=mine)
    assert seen == [(False, 16, 0.2)]
    want = ops.attention(tq, tk, tv, causal=False, window=16, sm_scale=0.2, mode="ref")
    assert torch.equal(got, want)
