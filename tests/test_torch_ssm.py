"""The port's Mamba2 block (chunked SSD) against the JAX package's, on the CPU.

Inputs and weights are numpy arrays from a seed (weights drawn by JAX and
carried by ``params_from_jax``).  Tolerances: in f32 rtol 1e-5 with atol
1e-6·max|y| (the SSD's three-operand einsums contract in another order
than XLA's, and the f32 sums round differently); in bf16 |Δ| ≤
2⁻⁵·max|y| (bf16 roundings at other places: SiLU rounds once in the port
and twice in JAX, ROADMAP Queue 3 item 27).  The chunked SSD against the
step-by-step recurrence at ``tests/test_models_smoke.py``'s 5e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.convert import KEEP_F32, params_from_jax  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

RTOL = 1e-5
ATOL_SHARE = 1e-6
BF16_SHARE = 2.0 ** -5

D_MODEL, D_INNER, N_STATE, D_HEAD = 32, 64, 8, 16


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _close_f32(got, want):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=RTOL,
                               atol=ATOL_SHARE * max(float(np.abs(want).max()), 1e-30))


def _close_bf16(got, want):
    got, want = _np(got), _np(want)
    assert np.abs(got - want).max() <= BF16_SHARE * np.abs(want).max()


def _close(got, want, dtype):
    (_close_f32 if dtype == "float32" else _close_bf16)(got, want)


def _pair(a, dtype):
    """The same numpy array as a JAX array and a tensor of ``dtype``."""
    a = np.asarray(a, np.float32)
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
        return jnp.asarray(a), torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _block_params(dtype, seed=0):
    p = jax.device_get(jssm.init_mamba2(jax.random.PRNGKey(seed), D_MODEL, D_INNER, N_STATE,
                                        d_head=D_HEAD, dtype=jnp.dtype(dtype)))
    # A_log, D and dt_bias are zeros and ones at init: give them values
    rng = np.random.default_rng(seed + 1)
    h = D_INNER // D_HEAD
    p["A_log"] = rng.normal(0, 0.5, h).astype(np.float32)
    p["D"] = rng.normal(1, 0.3, h).astype(np.float32)
    p["dt_bias"] = rng.normal(0, 0.5, h).astype(np.float32)
    return p, params_from_jax(p, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_causal_conv_matches_jax(dtype, with_state):
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng.normal(size=(2, 9, 24)), dtype)
    jw, tw = _pair(rng.normal(size=(4, 24)), dtype)
    js, ts = _pair(rng.normal(size=(2, 3, 24)), dtype) if with_state else (None, None)
    jy, jst = jssm._causal_conv(jx, jw, js)
    ty, tst = ssm._causal_conv(tx, tw, ts)
    assert ty.dtype == tx.dtype and tst.dtype == tx.dtype
    _close(ty, jy, dtype)
    np.testing.assert_array_equal(_np(tst), _np(jst))   # the last K − 1 inputs, unchanged


def test_causal_conv_state_does_not_hold_its_input():
    """The new state is a copy: a view of the padded input would keep all
    of it alive while a prefill keeps every layer's state."""
    x = torch.randn(2, 50, 8)
    _, st = ssm._causal_conv(x, torch.randn(4, 8))
    assert st.shape == (2, 3, 8) and st.untyped_storage().nbytes() == st.numel() * 4
    assert torch.equal(st, x[:, -3:])


def test_causal_conv_adds_its_taps_in_jaxs_order_in_bf16():
    """0 + x₀w₀ + x₁w₁ + x₂w₂ + x₃w₃, each add rounded to bf16: the sum the
    port gives is that left fold's, not an f32 sum rounded once."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(1, 6, 16)), dtype=torch.bfloat16)
    w = torch.tensor(rng.normal(size=(4, 16)), dtype=torch.bfloat16)
    xp = torch.cat([x.new_zeros((1, 3, 16)), x], dim=1)
    fold = xp[:, 0:6] * w[0]
    for i in range(1, 4):
        fold = fold + xp[:, i:i + 6] * w[i]
    y, _ = ssm._causal_conv(x, w)
    assert torch.equal(y, torch.nn.functional.silu(fold))


def _ssd_inputs(dtype, b=2, s=16, h=3, p=4, n=5, seed=5):
    rng = np.random.default_rng(seed)
    x = _pair(rng.normal(size=(b, s, h, p)), dtype)
    a = -np.abs(rng.normal(0, 0.7, (b, s, h))).astype(np.float32)   # log-decay ≤ 0
    bm = _pair(rng.normal(size=(b, s, n)), dtype)
    cm = _pair(rng.normal(size=(b, s, n)), dtype)
    s0 = rng.normal(size=(b, h, n, p)).astype(np.float32)
    return (x, (jnp.asarray(a), torch.from_numpy(a)), bm, cm,
            (jnp.asarray(s0), torch.from_numpy(s0)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [8, 1])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_ssd_chunked_matches_jax(dtype, chunk, with_state):
    x, a, bm, cm, s0 = _ssd_inputs(dtype)
    jy, jst = jssm.ssd_chunked(x[0], a[0], bm[0], cm[0], chunk=chunk,
                               init_state=s0[0] if with_state else None)
    ty, tst = ssm.ssd_chunked(x[1], a[1], bm[1], cm[1], chunk=chunk,
                              init_state=s0[1] if with_state else None)
    assert ty.dtype == x[1].dtype and tst.dtype == torch.float32
    _close(ty, jy, dtype)
    _close(tst, jst, dtype)


def test_ssd_chunked_masks_the_overflowing_upper_triangle():
    """A strong decay makes exp() of the upper triangle's differences
    overflow to inf; it is masked to 0 after the exp, as in JAX, and the
    output stays finite and equal to JAX's."""
    x, a, bm, cm, _ = _ssd_inputs("float32", s=16)
    big = np.full((2, 16, 3), -30.0, np.float32)
    jy, _ = jssm.ssd_chunked(x[0], jnp.asarray(big), bm[0], cm[0], chunk=16)
    ty, _ = ssm.ssd_chunked(x[1], torch.from_numpy(big), bm[1], cm[1], chunk=16)
    assert bool(torch.isfinite(ty).all())
    _close_f32(ty, jy)


def test_ssd_chunked_keeps_f64_in_f64():
    """f64 inputs run the state math in f64 (the card's yardstick; JAX
    casts to f32, ROADMAP Queue 3 item 28): the f32 run is within f32's
    rounding of it, and bf16 and f32 inputs still run in f32."""
    x, a, bm, cm, s0 = _ssd_inputs("float32")
    y64, st64 = ssm.ssd_chunked(x[1].double(), a[1].double(), bm[1].double(), cm[1].double(),
                                chunk=8, init_state=s0[1].double())
    y32, st32 = ssm.ssd_chunked(x[1], a[1], bm[1], cm[1], chunk=8, init_state=s0[1])
    assert y64.dtype == st64.dtype == torch.float64 and st32.dtype == torch.float32
    gap = float(torch.linalg.vector_norm(y32.double() - y64) / torch.linalg.vector_norm(y64))
    assert 0 < gap <= 1e-6
    _, st16 = ssm.ssd_chunked(x[1].bfloat16(), a[1], bm[1].bfloat16(), cm[1].bfloat16(),
                              chunk=8)
    assert st16.dtype == torch.float32


def test_ssd_chunked_refuses_a_ragged_chunk():
    x, a, bm, cm, _ = _ssd_inputs("float32", s=12)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssm.ssd_chunked(x[1], a[1], bm[1], cm[1], chunk=8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_mamba2_block_matches_jax(dtype, with_state):
    jp, tp = _block_params(dtype)
    rng = np.random.default_rng(6)
    jx, tx = _pair(rng.normal(size=(2, 16, D_MODEL)), dtype)
    kw = dict(d_inner=D_INNER, ssm_state=N_STATE, d_head=D_HEAD, chunk=8)
    jstate = tstate = None
    if with_state:
        jc, tc = _pair(rng.normal(size=(2, 3, D_INNER)), dtype)
        s0 = rng.normal(size=(2, D_INNER // D_HEAD, N_STATE, D_HEAD)).astype(np.float32)
        jstate, tstate = (jc, jnp.asarray(s0)), (tc, torch.from_numpy(s0))
    jy, (jconv, jssm_) = jssm.mamba2_block(jp, jx, state=jstate, **kw)
    ty, (tconv, tssm) = ssm.mamba2_block(tp, tx, state=tstate, **kw)
    assert ty.dtype == tx.dtype and tconv.dtype == tx.dtype and tssm.dtype == torch.float32
    _close(ty, jy, dtype)
    np.testing.assert_array_equal(_np(tconv), _np(jconv))
    _close(tssm, jssm_, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_matches_jax(dtype):
    jp, tp = _block_params(dtype, seed=2)
    rng = np.random.default_rng(7)
    jx, tx = _pair(rng.normal(size=(3, 1, D_MODEL)), dtype)
    jc, tc = _pair(rng.normal(size=(3, 3, D_INNER)), dtype)
    s0 = rng.normal(size=(3, D_INNER // D_HEAD, N_STATE, D_HEAD)).astype(np.float32)
    kw = dict(d_inner=D_INNER, ssm_state=N_STATE, d_head=D_HEAD)
    jy, (_, js) = jssm.mamba2_decode(jp, jx, (jc, jnp.asarray(s0)), **kw)
    ty, (_, ts) = ssm.mamba2_decode(tp, tx, (tc, torch.from_numpy(s0)), **kw)
    _close(ty, jy, dtype)
    _close(ts, js, dtype)


def test_mamba2_decode_is_the_block_at_chunk_one():
    _, tp = _block_params("float32", seed=3)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(2, 1, D_MODEL)).astype(np.float32))
    st = (torch.from_numpy(rng.normal(size=(2, 3, D_INNER)).astype(np.float32)),
          torch.from_numpy(rng.normal(size=(2, 4, N_STATE, D_HEAD)).astype(np.float32)))
    kw = dict(d_inner=D_INNER, ssm_state=N_STATE, d_head=D_HEAD)
    y, (c, s) = ssm.mamba2_decode(tp, x, st, **kw)
    y2, (c2, s2) = ssm.mamba2_block(tp, x, chunk=1, state=st, **kw)
    assert torch.equal(y, y2) and torch.equal(c, c2) and torch.equal(s, s2)


def _block_by_split(p, x, *, d_inner, ssm_state, d_head, chunk, state=None):
    """``mamba2_block`` as one ``torch.split`` of in_proj's output, the
    formulation before the mixer could run per rank."""
    from repro_torch.models import layers as L

    b, s, _ = x.shape
    h, n = d_inner // d_head, ssm_state
    u = x @ p["in_proj"]
    z, xs, Bm, Cm, dt = torch.split(u, [d_inner, d_inner, n, n, h], dim=-1)
    xs, new_conv = ssm._causal_conv(xs, p["conv_w"], state[0] if state is not None else None)
    dt = torch.nn.functional.softplus(dt.to(ssm._math_dtype(x.dtype)) + p["dt_bias"])
    xh = xs.reshape(b, s, h, d_head) * dt[..., None].to(xs.dtype)
    y, new_ssm = ssm.ssd_chunked(xh, dt * -torch.exp(p["A_log"]), Bm, Cm, chunk=chunk,
                                 init_state=state[1] if state is not None else None)
    y = y + xh * p["D"].to(xh.dtype)[None, None, :, None]
    y = L.rmsnorm(y.reshape(b, s, d_inner) * torch.nn.functional.silu(z), p["norm"])
    return (y @ p["out_proj"]).to(x.dtype), (new_conv, new_ssm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_per_rank_mamba_on_plain_tensors_keeps_the_blocks_bits(dtype, with_state):
    """On plain tensors ``sharding.per_rank_mamba`` is the block itself:
    ``mamba2_block`` (which calls it) gives the bits of the block written
    as one split of in_proj's output, and the mixer given all its heads
    the same y and state."""
    from repro_torch.models.sharding import per_rank_mamba

    _, tp = _block_params(dtype, seed=5)
    rng = np.random.default_rng(10)
    _, x = _pair(rng.normal(size=(2, 16, D_MODEL)), dtype)
    kw = dict(d_inner=D_INNER, ssm_state=N_STATE, d_head=D_HEAD, chunk=8)
    state = None
    if with_state:
        _, conv = _pair(rng.normal(size=(2, 3, D_INNER)), dtype)
        state = (conv, torch.from_numpy(rng.normal(size=(2, D_INNER // D_HEAD, N_STATE, D_HEAD))
                                        .astype(np.float32)))
    y, (conv, st) = ssm.mamba2_block(tp, x, state=state, **kw)
    want, (want_conv, want_st) = _block_by_split(tp, x, state=state, **kw)
    assert torch.equal(y, want) and torch.equal(conv, want_conv) and torch.equal(st, want_st)
    out, (conv, st) = per_rank_mamba(ssm._mamba_mix, x, tp, state, **kw)
    mixed, (conv2, st2) = ssm._mamba_mix(x @ tp["in_proj"], tp, state,
                                         heads=(0, D_INNER // D_HEAD), **kw)
    assert torch.equal(conv, conv2) and torch.equal(st, st2)
    assert torch.equal(out, y) and torch.equal((mixed @ tp["out_proj"]).to(x.dtype), y)


def test_mamba_mix_of_a_slice_of_heads_is_that_slice_of_the_whole():
    """``_mamba_mix`` given heads (first, h) computes those heads' channels
    of the pre-norm y and their state (the norm then over all of d_inner,
    as ``per_rank_mamba`` sums it over the ranks)."""
    _, tp = _block_params("float32", seed=6)
    rng = np.random.default_rng(11)
    u = torch.from_numpy(rng.normal(size=(2, 16, 2 * D_INNER + 2 * N_STATE + D_INNER // D_HEAD))
                         .astype(np.float32))
    kw = dict(d_inner=D_INNER, ssm_state=N_STATE, d_head=D_HEAD, chunk=8,
              norm=lambda y, w: y * w)
    whole, (conv, st) = ssm._mamba_mix(u, tp, None, **kw)
    for first, h in ((0, 2), (2, 2), (1, 1)):
        part, (pc, ps) = ssm._mamba_mix(u, tp, None, heads=(first, h), **kw)
        c = slice(first * D_HEAD, (first + h) * D_HEAD)
        torch.testing.assert_close(part, whole[..., c], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(pc, conv[..., c], rtol=0, atol=0)
        torch.testing.assert_close(ps, st[:, first:first + h], rtol=1e-6, atol=1e-6)


def test_mamba2_chunked_matches_stepwise():
    """The chunked SSD equals feeding one token at a time through the
    decode path (``tests/test_models_smoke.py``'s check, in the port)."""
    _, tp = _block_params("float32", seed=8)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(2, 32, D_MODEL)).astype(np.float32))
    kw = dict(d_inner=D_INNER, ssm_state=N_STATE, d_head=D_HEAD)
    y_chunk, (_, st_chunk) = ssm.mamba2_block(tp, x, chunk=8, **kw)
    state = (torch.zeros((2, 3, D_INNER)), torch.zeros((2, D_INNER // D_HEAD, N_STATE, D_HEAD)))
    ys = []
    for t in range(32):
        y, state = ssm.mamba2_decode(tp, x[:, t:t + 1], state, **kw)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_chunk.numpy(), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(state[1].numpy(), st_chunk.numpy(), rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_mamba2_makes_jaxs_tree(dtype):
    """The port's leaves have JAX's names, shapes and dtypes (the decay
    leaves f32 whatever the model's dtype), stacked on a lead."""
    want = jax.device_get(jssm.init_mamba2(jax.random.PRNGKey(0), D_MODEL, D_INNER, N_STATE,
                                           d_head=D_HEAD, dtype=jnp.dtype(str(dtype)[6:])))
    got = ssm.init_mamba2(torch.Generator("cpu").manual_seed(0), D_MODEL, D_INNER, N_STATE,
                          d_head=D_HEAD, dtype=dtype, lead=(3,))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == (3,) + w.shape, k
        assert str(got[k].dtype)[6:] == str(w.dtype), k


def test_params_from_jax_keeps_the_decays_f32():
    """Carried at bf16, Mamba2's A_log, D and dt_bias and RWKV's w0 and u
    stay f32, as JAX makes them; the projections become bf16."""
    p = jax.device_get(jssm.init_mamba2(jax.random.PRNGKey(0), D_MODEL, D_INNER, N_STATE))
    p.update(jax.device_get(jssm.init_rwkv6(jax.random.PRNGKey(1), 64, 96)))
    tp = params_from_jax(p, "cpu", torch.bfloat16)
    for k, t in tp.items():
        assert t.dtype == (torch.float32 if k in KEEP_F32 else torch.bfloat16), k
    assert {"A_log", "D", "dt_bias", "w0", "u"} <= set(KEEP_F32)


def test_ssd_gradients_stay_finite_where_a_chunks_decay_overflows():
    """A chunk whose log-decay sums past f32's exp range (here −8 a step
    over 16 steps): the upper triangle's exp(diff) is inf.  The JAX
    package masks it to 0 after the exp, so its f32 gradient is NaN
    (0·inf); the port masks before the exp: the same outputs, and f32
    gradients that are finite and within 1e-4 of the port's f64 ones."""
    rng = np.random.default_rng(7)
    b, s, h, p, n, c = 1, 32, 2, 4, 3, 16
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    a = np.full((b, s, h), -8.0, np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)

    jg = jax.grad(lambda a: jnp.sum(jssm.ssd_chunked(x, a, bm, cm, chunk=c)[0]))(a)
    assert np.isnan(np.asarray(jg)).any()          # the reference's NaN, through the decay

    def grad(dtype):
        t = torch.from_numpy(a).to(dtype).requires_grad_()
        y, _ = ssm.ssd_chunked(torch.from_numpy(x).to(dtype), t,
                               *(torch.from_numpy(v).to(dtype) for v in (bm, cm)), chunk=c)
        y.sum().backward()
        return y.detach(), t.grad

    y32, g32 = grad(torch.float32)
    y64, g64 = grad(torch.float64)
    jy = np.asarray(jssm.ssd_chunked(x, a, bm, cm, chunk=c)[0])
    _close_f32(y32, jy)                              # JAX's outputs
    assert bool(torch.isfinite(g32).all())
    np.testing.assert_allclose(g32.double().numpy(), g64.numpy(), rtol=1e-4,
                               atol=1e-4 * float(g64.abs().max()))
