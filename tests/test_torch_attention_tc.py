"""The tensor-core flash_attention's recipe against the JAX package, on the CPU.

``ref.flash_attention_tiled`` is the plain version of the bf16 kernel's
arithmetic (f32 logits of the bf16 inputs, the scale on the logits, an f32
online softmax over kv tiles of 128, the weights rounded to bf16 before the
product with v).  Here it is held against the JAX Pallas kernel in
interpret mode on the same numpy inputs, within the bound that
``chip_smoke.py`` holds the kernel to: |Δ| ≤ 2^-7·|want| + 1e-3·max|v|
(two bf16 roundings: the output's, and the weights' before the second
product).  With the weights kept in f32 it is held to the plain
``ref.flash_attention`` at f32's rtol 1e-4, atol 1e-5.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels.flash_attention import flash_attention_p  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

BF16_REL, BF16_VMAX = 2.0 ** -7, 1e-3
VARIANTS = [dict(causal=True), dict(causal=False), dict(causal=True, window=64),
            dict(causal=False, window=128, sm_scale=0.3), dict(causal=True, window=128),
            dict(causal=True, sm_scale=0.05)]
#: S × D × group, each with the next variant in turn (as chip_smoke.py's edge cases)
CASES = [(s, d, g, VARIANTS[i % len(VARIANTS)]) for i, (s, d, g) in
         enumerate(itertools.product((1, 77, 200, 256), (32, 64, 128), (1, 6)))]
#: D = 112 (Zamba2-7B's shared attention, which the tensor-core kernel runs
#: in its D = 128 tile, zero-filled): the same S, groups 1 and 4
CASES += [(s, 112, g, VARIANTS[i % len(VARIANTS)]) for i, (s, g) in
          enumerate(itertools.product((1, 77, 200, 256), (1, 4)))]


def _inputs(s, d, group, seed, dtype):
    """(2, 2·group, s, d) queries over 2 kv heads, from a seeded numpy
    generator, rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, h, s, d)).astype(dtype) for h in (2 * group, 2, 2)]


def _pallas(arrays, kw):
    """The JAX Pallas kernel in interpret mode; S not a multiple of its
    128-row blocks takes one block of S."""
    s = arrays[0].shape[2]
    blk = 128 if s % 128 == 0 else s
    q, k, v = (jnp.asarray(a) for a in arrays)
    out = flash_attention_p(q, k, v, block_q=blk, block_k=blk, interpret=True, **kw)
    return np.asarray(out, np.float32)


def _bf16(arrays):
    return [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) for a in arrays]


def _assert_within_bf16_bound(got, want, v):
    bound = BF16_REL * np.abs(want) + BF16_VMAX * float(np.abs(v).max())
    err = np.abs(got - want)
    assert (err <= bound).all(), (float(err.max()), float((err / bound).max()))


@pytest.mark.parametrize("s,d,group,kw", CASES,
                         ids=[f"S{s}-D{d}-g{g}-{'-'.join(f'{k}{v}' for k, v in kw.items())}"
                              for s, d, g, kw in CASES])
def test_tiled_recipe_matches_pallas(s, d, group, kw):
    arrays = _inputs(s, d, group, seed=s + d + group, dtype=ml_dtypes.bfloat16)
    want = _pallas(arrays, kw)
    q, k, v = _bf16(arrays)
    got = ref.flash_attention_tiled(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _assert_within_bf16_bound(got.float().numpy(), want, v.float().numpy())


@pytest.mark.parametrize("kw", VARIANTS)
@pytest.mark.parametrize("s,d,group", [(77, 64, 6), (256, 128, 1)])
def test_tiled_recipe_in_f32_matches_plain_version(s, d, group, kw):
    """Weights kept in f32: the recipe is the plain version's function,
    summed in tiles, at f32's tolerance."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(s, d, group, seed=s * d, dtype=np.float32))
    got = ref.flash_attention_tiled(q, k, v, p_dtype=torch.float32, **kw)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref.flash_attention(q, k, v, **kw), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("block_k", [16, 64, 128, 512])
def test_tiled_recipe_tiles_do_not_move_f32(block_k):
    """In f32 the tile width changes only the order of the sums."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(200, 32, 6, seed=3, dtype=np.float32))
    got = ref.flash_attention_tiled(q, k, v, causal=True, window=100, block_k=block_k,
                                    p_dtype=torch.float32)
    want = ref.flash_attention(q, k, v, causal=True, window=100)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_tiled_recipe_fully_masked_rows_give_zero():
    """A row with every key masked outputs 0, as the plain version's (and
    the Pallas body's) l = 0 → 1 makes it."""
    q, k, v = _bf16(_inputs(8, 32, 1, seed=9, dtype=ml_dtypes.bfloat16))
    out = ref.flash_attention_tiled(q, k, v, causal=True, window=-1)
    assert torch.equal(out, torch.zeros_like(out))


def test_served_call_on_the_cpu_takes_the_plain_version():
    """On the CPU the wrapper's bf16 call is the plain ``ref.flash_attention``
    (the recipe is its yardstick on the card, not its CPU path)."""
    q, k, v = _bf16(_inputs(64, 64, 6, seed=4, dtype=ml_dtypes.bfloat16))
    assert torch.equal(ops.flash_attention(q, k, v), ref.flash_attention(q, k, v))
