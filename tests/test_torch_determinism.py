"""The port's f32 sums give the same bits whatever the order of their adds
(ROADMAP Queue 3 item 17), and stay within the query tolerance of the JAX
package and numpy.

* ``runtime._segment_sum`` (the sorted tiers' and the plain direct tier's
  sums: on the CPU 1,024-row chunks, then their partials; on a card
  ``fixed_sum``'s integers) against
  ``jax.ops.segment_sum`` and numpy's f64, on an order-sensitive bucket and
  on a stand-in for Q1's 490,000-row group at sf=5;
* ``ref.fixed_sum``, the plain version of ``csrc/fixsum.cuh`` (the atomic
  routes' integer sums), against the same, bit for bit the same under any
  permutation of the rows, with its accuracy bound, infinities and NaN.

The card's side (each route twice, the same bits) is in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.relational import runtime as rt  # noqa: E402

QUERY_RTOL = 2e-4


def _jax_segment_sum(v, g, k):
    return np.asarray(jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(g), num_segments=k))


def _f64(v, g, k):
    out, scale = np.zeros((k,) + v.shape[1:]), np.zeros((k,) + v.shape[1:])
    keep = (g >= 0) & (g < k)
    np.add.at(out, g[keep], v[keep].astype(np.float64))
    np.add.at(scale, g[keep], np.abs(v[keep].astype(np.float64)))
    return out, scale


def _order_sensitive(n, seed=0):
    """1e8, v, −1e8, … with v normal times 10^U(−4, 8): a sum whose bits
    depend on the order of its adds."""
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=n) * 10.0 ** rng.uniform(-4, 8, n)).astype(np.float32)
    m = 3 * (n // 3)
    v[:m] = np.where(np.arange(m) % 3 == 1, v[:m], np.tile(np.float32([1e8, 0, -1e8]), n // 3))
    return v


@pytest.mark.parametrize("case", ["order_sensitive", "random", "q1_group"])
def test_segment_sum_matches_jax_and_numpy(case):
    """One bucket of order-sensitive rows over several 1,024-row chunks;
    normal rows over 40 segments; and 49,000 rows of Q1's
    ``l_extendedprice·(1 − l_discount)`` in one group (a tenth of its
    490,000-row group at sf=5, where one f32 accumulator lost 1.48e-4 on
    the card, item 4).  Each within the query tolerance of numpy's f64
    (of the segment's Σ|v| where the sum cancels) and of JAX's."""
    rng = np.random.default_rng(4)
    if case == "order_sensitive":
        v, g, k = _order_sensitive(5000), np.zeros(5000, np.int64), 1
    elif case == "random":
        v, g, k = rng.normal(size=20_000).astype(np.float32), rng.integers(0, 40, 20_000), 40
    else:
        price = rng.uniform(900, 105_000, 49_000).astype(np.float32)
        disc = (rng.integers(0, 11, 49_000) / 100).astype(np.float32)
        v, g, k = (price * (np.float32(1) - disc)).astype(np.float32), np.zeros(49_000, np.int64), 1
    got = rt._segment_sum(torch.from_numpy(v), torch.from_numpy(g), k).numpy()
    want, scale = _f64(v, g, k)
    assert np.all(np.abs(got - want) <= QUERY_RTOL * np.maximum(np.abs(want), 1e-3 * scale))
    jx = _jax_segment_sum(v, g, k)
    assert np.all(np.abs(got - jx) <= QUERY_RTOL * np.maximum(np.abs(want), 1e-3 * scale)
                  + 1e-6 * scale)
    if case == "q1_group":
        assert abs(got[0] - want[0]) <= 1e-6 * want[0]


@pytest.mark.parametrize("case", ["order_sensitive", "random", "wide", "rows_2d"])
def test_fixed_sum_matches_jax_and_numpy_and_ignores_the_order(case):
    """``ref.fixed_sum`` (the atomic routes' recipe) within 2^-40 of Σ|v|
    of numpy's f64 before its f32 rounding, within the query tolerance of
    JAX's ``segment_sum``, and bit for bit the same after any permutation
    of the rows (the property the card's atomics need); ids outside the
    segments dropped."""
    rng = np.random.default_rng(7)
    if case == "order_sensitive":
        v, g, k = _order_sensitive(30_000), rng.integers(0, 3, 30_000), 3
    elif case == "random":
        v, g, k = rng.normal(size=30_000).astype(np.float32), rng.integers(-2, 60, 30_000), 57
    elif case == "wide":
        v = (rng.normal(size=30_000) * 10.0 ** rng.uniform(-30, 30, 30_000)).astype(np.float32)
        g, k = rng.integers(0, 5, 30_000), 5
    else:
        v, g, k = rng.normal(size=(8_000, 6)).astype(np.float32), rng.integers(-1, 9, 8_000), 8
    got = ref.fixed_sum(torch.from_numpy(v), torch.from_numpy(g), k).numpy()
    want, scale = _f64(v, g, k)
    assert np.all(np.abs(got - want) <= 2.0 ** -40 * scale + np.abs(want) * 2.0 ** -24)
    keep = (g >= 0) & (g < k)
    jx = _jax_segment_sum(v[keep], g[keep], k)
    assert np.all(np.abs(got - jx) <= QUERY_RTOL * np.maximum(np.abs(want), 1e-3 * scale)
                  + 1e-6 * scale)
    for seed in range(3):
        p = np.random.default_rng(seed).permutation(len(v))
        again = ref.fixed_sum(torch.from_numpy(v[p]), torch.from_numpy(g[p]), k).numpy()
        assert again.tobytes() == got.tobytes()


def test_fixed_sum_of_a_sum_that_f32_adds_in_another_order_differs():
    """The order-sensitive bucket: an f32 sum gives other bits in another
    order (the fault the card's atomics showed), the fixed sum does not,
    and it is the f64 sum rounded to f32 here (every row exact at the
    bucket's scale)."""
    v = _order_sensitive(3000, seed=1)
    orders = [np.arange(3000), np.random.default_rng(2).permutation(3000)]
    f32 = {np.add.reduce(v[p], dtype=np.float32).tobytes() for p in orders}
    fixed = {ref.fixed_sum(torch.from_numpy(v[p]), torch.zeros(3000, dtype=torch.int64), 1)
             .numpy().tobytes() for p in orders}
    assert len(f32) == 2 and len(fixed) == 1
    exact = np.float32(np.sum(v.astype(np.float64)))
    got = ref.fixed_sum(torch.from_numpy(v), torch.zeros(3000, dtype=torch.int64), 1)
    assert abs(float(got[0]) - float(exact)) <= 2.0 ** -40 * float(np.sum(np.abs(v)))


@pytest.mark.parametrize("shape", [(0,), (0, 8)])
def test_fixed_sum_of_no_rows_is_zeros(shape):
    """No rows: every segment's sum is 0, as the kernel's finish writes it
    (a segsum of no points)."""
    got = ref.fixed_sum(torch.zeros(shape), torch.zeros(0, dtype=torch.int32), 5)
    assert got.shape == (5,) + shape[1:] and bool((got == 0).all())
    assert torch.equal(rt._segment_sum(torch.zeros(shape), torch.zeros(0, dtype=torch.int64), 5),
                       torch.zeros((5,) + shape[1:]))


def test_fixed_sum_infinities_nan_zeros_and_subnormals():
    """A NaN, or +inf beside −inf, gives NaN, infinities of one sign that
    infinity, as an f32 sum does; zeros and subnormals add exactly."""
    inf, nan = np.float32(np.inf), np.float32(np.nan)
    v = np.array([1, inf, 2, -inf, 3, inf, inf, 4, nan, 5, 1e-45, -1e-45, 3e-44, 0, -0.0, 1e-40],
                 np.float32)
    g = np.array([0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 5, 6, 6, 7])
    got = ref.fixed_sum(torch.from_numpy(v), torch.from_numpy(g), 8).numpy()
    assert got[0] == inf
    assert got[1] == -inf and got[2] == inf and got[3] == inf and np.isnan(got[4])
    assert got[5] == np.float32(3e-44) and got[6] == 0 and got[7] == np.float32(1e-40)
    both = ref.fixed_sum(torch.from_numpy(np.array([inf, -inf], np.float32)),
                         torch.zeros(2, dtype=torch.int64), 1).numpy()
    assert np.isnan(both[0])
