"""The tensor-core kmeans_step's recipe against the JAX package, on the CPU.

``ref.kmeans_step_tiled`` is the plain version of the tensor-core kernel's
arithmetic (``csrc/kmeans_step.cu``, ``kms_tc``): TF32 rounding as
``cvt.rna`` does it (the points' low parts read toward zero, as an mma
reads an f32 operand), the three-way hi/lo split of the score
‖c‖² + x·(−2c), exact copies of a centroid set aside, and per-tile one-hot
sums of x_hi + x_lo added in the fixed order that a tiling gives (the
kernel's own comes from the library on the card, ``ops.onehot_tiling``;
here the recipe takes a few, among them the H100's at d = 8, and any tiling
must meet the rule).  Here it is held,
on the same numpy inputs, against the JAX Pallas kernel in interpret mode
(``repro.kernels.kmeans_step.kmeans_step_p``) and against the f64
reference step, by the tie-margin rule of ``repro_torch.kmeans``
(``check_step``) at the kernels' rtol 1e-4: counts add up to n and sums to
Σx; each count may move only by its ambiguous points (another centroid's
f64 d² within TIE·d·2^-23·(‖x‖² + ‖c‖²) of the nearest), each sum by those
points' |x| plus 1e-5 of its Σ|x|.  A single unsplit TF32 pass breaks that
rule on the examples' data, which is why the kernel splits.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.kmeans_step import kmeans_step_p  # noqa: E402
from repro_torch import kmeans  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RTOL = 1e-4
#: tilings of the recipe: the H100's kms_tc<16, 8> (512-point tiles, 8
#: warps, 132 SMs × 2 blocks, groups of 32), and smaller ones that give
#: each block several tiles and the finish several groups
H100_D8 = ref.KmsTiling(tile=512, warps=8, grid=264, group=32)
SMALL = ref.KmsTiling(tile=128, warps=8, grid=7, group=4)
#: d × k with a ragged n each (not a multiple of 8, 16 or a tile)
SHAPES = [(1000 + 37 * i, d, k) for i, (d, k) in
          enumerate(itertools.product((1, 3, 8, 32), (1, 7, 16, 64)))]


def _pallas(x, c):
    """The JAX Pallas kernel in interpret mode, one block where n is not a
    multiple of its 1024 rows (no padding rows to take off)."""
    n = x.shape[0]
    blk = 1024 if n % 1024 == 0 else n
    sums, counts = kmeans_step_p(jnp.asarray(x), jnp.asarray(c), block_rows=blk, interpret=True)
    return np.asarray(sums), np.asarray(counts)


def _recipe(x, c, tiling=H100_D8, **kw):
    return ref.kmeans_step_tiled(torch.from_numpy(x), torch.from_numpy(c), tiling, **kw)


def _check_both(what, x, c, **kw):
    """The recipe against the Pallas kernel and the f64 reference; returns
    the recipe's step and the reference."""
    stats = kmeans.reference_step(x, c)
    got = _recipe(x, c, **kw)
    kmeans.check_step(f"{what} vs pallas", got, _pallas(x, c), stats, RTOL)
    kmeans.check_step(f"{what} vs f64", got, (stats.sums, stats.counts), stats, RTOL)
    return got, stats


def test_tf32_rounds_to_nearest_ties_away():
    v = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 1 + 3 * 2 ** -11,
                      1 + 2 ** -11 - 2 ** -23, 3.0, 0.0, float("inf"), float("-inf")])
    want = [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -9, 1.0, 3.0, 0.0,
            float("inf"), float("-inf")]
    assert ref.tf32(v).tolist() == want
    assert bool(torch.isnan(ref.tf32(torch.tensor([float("nan")]))).all())
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 100, 10_000).astype(np.float32))
    hi, lo = ref.tf32_split(x)
    for part in (hi, lo):  # both TF32: the 13 low mantissa bits clear
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((hi.double() + lo.double() - x.double()).abs()
                 <= 2.0 ** -23 * x.double().abs()).all())


def test_points_split_takes_the_rest_toward_zero():
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 100, 10_000).astype(np.float32))
    hi, lo = ref.tf32_points(x)
    assert torch.equal(hi, ref.tf32(x))
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    rest = x.double() - hi.double()  # exact in f32
    assert bool((lo.double().abs() <= rest.abs()).all())  # toward zero
    # the rest lies on x's f32 grid with at most 12 significant bits, so
    # reading it as TF32 loses at most one f32 unit of x
    assert bool(((rest - lo.double()).abs() <= 2.0 ** -23 * x.double().abs()).all())


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_recipe_matches_pallas_and_reference(n, d, k):
    x, c = kmeans.make_data(n, d, k, seed=n)
    _check_both(f"n={n} d={d} k={k}", x, c, tiling=SMALL if d > 8 else H100_D8)


def test_recipe_with_a_large_common_offset():
    # means near 1e3: ‖x‖², ‖c‖² and 2·x·c near 8e6 cancel in the expansion
    x, c = kmeans.make_data(4096, 8, 16, 1)
    _check_both("offset 1e3", x + np.float32(1000), c + np.float32(1000))


def test_recipe_on_near_ties():
    x, c = kmeans.make_data(2003, 8, 16, 2)
    rng = np.random.default_rng(2)
    a, b = rng.integers(0, 16, 600), rng.integers(0, 16, 600)
    mid = (c[a].astype(np.float64) + c[b]) / 2  # the midpoint of two centroids, nudged
    x[:600] = (mid + rng.normal(0, 1e-6, mid.shape)).astype(np.float32)
    got, stats = _check_both("near ties", x, c)
    assert stats.n_amb > 0  # the case does make ambiguous points


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recipe_on_adversarial_near_ties_at_d1(seed):
    """d = 1, where the split's worst case fills the tie margin (the source
    note of ``csrc/kmeans_step.cu``): centroids whose low bits sit near half
    a TF32 unit, points within 24 f32 units of their midpoints, with low
    bits near half a unit as well.  Every label the recipe gives stays
    inside the rule, against the Pallas kernel and the f64 step."""
    x, c = kmeans.near_ties(16, 256, 24, seed)
    assert (np.abs((x.view(np.int32) & 0x1FFF) - 0x1000) <= 32).all()
    got, stats = _check_both(f"d=1 near ties, seed {seed}", x, c)
    assert stats.n_amb > 0.05 * len(x)  # most points near a midpoint are ambiguous
    labels = ref.kmeans_labels_tiled(torch.from_numpy(x), torch.from_numpy(c))
    assert not torch.equal(labels, torch.argmin(ref.cdist2(torch.from_numpy(x),
                                                           torch.from_numpy(c)), 1))


def test_recipe_on_duplicate_and_far_centroids():
    x, c = kmeans.make_data(4099, 8, 6, 3)
    c[4] = c[2]      # an exact copy: its points go to index 2, index 4 counts 0
    c[5] = 1e4       # far from every point: an empty cluster
    (sums, counts), _ = _check_both("copies", x, c)
    assert counts[4] == 0 and counts[2] > 0 and counts[5] == 0
    assert bool((sums[4] == 0).all()) and bool((sums[5] == 0).all())
    assert torch.isinf(ref.kmeans_norms(torch.from_numpy(c))[4])


@pytest.mark.parametrize("offset", [0.0, 1000.0])
def test_unsplit_tf32_fails_on_the_examples_data(offset):
    x, c = kmeans.make_data(1 << 16, 8, 16, 0)
    x, c = x + np.float32(offset), c + np.float32(offset)
    stats = kmeans.reference_step(x, c)
    want = (stats.sums, stats.counts)
    kmeans.check_step("split", _recipe(x, c), want, stats, RTOL)
    with pytest.raises(AssertionError, match="counts differ"):
        kmeans.check_step("unsplit", _recipe(x, c, split=False), want, stats, RTOL)


@pytest.mark.parametrize("n", [0, 1, 100, 511, 513, 1 << 15])
def test_recipe_around_tiles_and_blocks(n):
    """Fewer points than a tile, one past a tile, and more tiles than
    blocks (each block then takes several in order, the finish adds
    several groups): the plain version's step within the tie-margin rule,
    and the same bits on a second run."""
    x, c = kmeans.make_data(max(n, 16), 8, 16, 4)
    x = x[:n]
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    got = ref.kmeans_step_tiled(xt, ct, SMALL)
    again = ref.kmeans_step_tiled(xt, ct, SMALL)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if n == 0:
        assert not bool(got[0].any()) and not bool(got[1].any())
        return
    kmeans.check_step(f"n={n}", got, ref.kmeans_step(xt, ct), kmeans.reference_step(x, c),
                      RTOL)


def test_recipe_labels_match_plain_version_away_from_ties():
    rng = np.random.default_rng(5)  # tight clusters around their centroids
    c = rng.normal(0, 5, (32, 16)).astype(np.float32)
    x = (c[rng.integers(0, 32, 1 << 14)] + rng.normal(0, 0.3, (1 << 14, 16))).astype(np.float32)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    stats = kmeans.reference_step(x, c)
    assert stats.n_amb == 0
    plain = torch.argmin(ref.cdist2(xt, ct), dim=1)
    assert torch.equal(ref.kmeans_labels_tiled(xt, ct), plain)


def test_cpu_wrapper_takes_the_plain_version():
    x, c = kmeans.make_data(1000, 8, 16, 6)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    before = dict(ops.KMEANS_LAUNCHES)
    got, want = ops.kmeans_step(xt, ct), ref.kmeans_step(xt, ct)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.KMEANS_LAUNCHES == before
