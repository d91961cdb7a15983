"""The port's MoE family against the JAX package's, on the CPU.

``moe_block`` on numpy inputs from a seed, with weights from JAX's
``init_moe`` carried by ``params_from_jax``; the reduced Moonlight and
Mixtral configs through forward, prefill, decode, the loss and its
gradients, train steps and a served wave.

Tolerances: ``moe_block`` in f32, out and aux rtol 1e-5 (atol 1e-6·max|y|:
the same f32 arithmetic, sums in another order), the routing (top-k
experts, each choice's place in its expert, which choices are kept)
exactly; in bf16 the combine gives JAX's CPU bits on the same expert
outputs, and the whole block is within 2^-5·max|y| of JAX's, because
``F.silu`` rounds once to bf16 and ``jax.nn.silu`` twice (the expert
products themselves agree bit for bit).  The reduced configs' logits
rtol/atol 2e-3 (``tests/test_models_smoke.py``); the loss rtol 1e-5 and
each gradient leaf ‖Δ‖ ≤ 1e-4·‖g‖.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.api import make_serve_step as jax_serve_step  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.launch.serve import Request, make_run_wave  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.models.api import build_model, make_train_step, value_and_grad  # noqa: E402
from repro_torch.train.optimizer import AdamW, tree_leaves  # noqa: E402

MOE_ARCHS = ["moonshot-v1-16b-a3b", "mixtral-8x7b"]
RTOL = 1e-5
TOL = 2e-3
GRAD_REL = 1e-4
D, F, E, K = 32, 48, 8, 2


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _moe_params(seed=1, d=D, f=F, e=E):
    return {k: np.array(v) for k, v in
            jax.device_get(jlayers.init_moe(jax.random.PRNGKey(seed), d, f, e)).items()}


def _jax_route(p, xf, n_experts, top_k, capacity):
    """JAX's routing, the lines of ``repro.models.layers.moe_block`` that
    choose the experts and place each choice: (topi, pos, keep)."""
    probs = jax.nn.softmax((xf @ p["router"]).astype(jnp.float32), axis=-1)
    _, topi = jax.lax.top_k(probs, top_k)
    flat_e = topi.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = jnp.searchsorted(sorted_e, jnp.arange(n_experts))
    pos_sorted = jnp.arange(flat_e.shape[0]) - start[sorted_e]
    pos = jnp.zeros(flat_e.shape, jnp.int32).at[order].set(pos_sorted.astype(jnp.int32))
    return np.asarray(topi), np.asarray(pos), np.asarray(pos < capacity)


def _both(p, x, cf, top_k=K, n_experts=E):
    """(port (y, aux, route), JAX (y, aux, route)) of moe_block on x."""
    t = x.shape[0] * x.shape[1]
    cap = layers.moe_capacity(t, top_k, n_experts, cf)
    jy, jaux = jlayers.moe_block(p, jnp.asarray(x), n_experts=n_experts, top_k=top_k,
                                 capacity_factor=cf)
    tp, tx = params_from_jax(p, "cpu"), params_from_jax(x, "cpu")
    ty, taux = layers.moe_block(tp, tx, n_experts=n_experts, top_k=top_k, capacity_factor=cf)
    _, _, topi, pos, keep = layers.moe_route(tp, tx.reshape(t, -1), n_experts=n_experts,
                                             top_k=top_k, capacity=cap)
    jroute = _jax_route(p, jnp.asarray(x).reshape(t, -1), n_experts, top_k, cap)
    return ((ty, taux, (topi.numpy(), pos.numpy(), keep.numpy())),
            (np.asarray(jy), np.asarray(jaux), jroute))


def _check_f32(got, want):
    (ty, taux, troute), (jy, jaux, jroute) = got, want
    for a, b in zip(troute, jroute):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=RTOL, atol=1e-6 * np.abs(jy).max())
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL)


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------


def test_moe_block_drop_free_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 16, D)).astype(np.float32)
    got, want = _both(_moe_params(), x, 8.0)
    _check_f32(got, want)
    assert want[2][2].all()  # capacity 8.0: nothing dropped


@pytest.mark.parametrize("cf", [1.0, 0.5])
def test_moe_block_with_drops_matches_jax(cf):
    """A skewed router (every token's first choice is expert 0) under a
    capacity factor ≤ 1: the kept choices are JAX's, dropped ones add
    nothing."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 16, D)) + 1.0).astype(np.float32)
    p = _moe_params()
    p["router"][:, 0] += 0.5
    got, want = _both(p, x, cf)
    _check_f32(got, want)
    keep = want[2][2]
    assert 0 < keep.sum() < keep.size
    assert (got[2][0][:, 0] == 0).all()


def test_moe_block_zero_router_picks_the_lowest_experts():
    """Equal probabilities: ``jax.lax.top_k`` takes the lowest indices, and
    so does the port (``torch.topk`` would not)."""
    x = np.random.default_rng(2).normal(size=(3, 8, D)).astype(np.float32)
    p = _moe_params()
    p["router"] = np.zeros_like(p["router"])
    got, want = _both(p, x, 8.0, top_k=3)
    _check_f32(got, want)
    np.testing.assert_array_equal(got[2][0], np.tile([0, 1, 2], (24, 1)))


def test_moe_route_ties_at_full_width():
    """Moonlight's width of router, all 64 experts tied: experts 0..5."""
    probs_router = {"router": torch.zeros((16, 64))}
    _, topw, topi, _, _ = layers.moe_route(probs_router, torch.randn(3, 16), n_experts=64,
                                           top_k=6, capacity=4)
    assert topi.tolist() == [[0, 1, 2, 3, 4, 5]] * 3
    torch.testing.assert_close(topw, torch.full((3, 6), 1 / 6))


def test_moe_capacity_is_jaxs_expression():
    assert layers.moe_capacity(8192, 6, 64, 1.25) == 960      # Moonlight's prefill wave
    assert layers.moe_capacity(4, 6, 64, 1.25) == 4           # its decode step
    assert layers.moe_capacity(8192, 2, 8, 1.25) == 2560      # Mixtral's
    assert layers.moe_capacity(7, 3, 5, 1.1) == int(7 * 3 / 5 * 1.1) == 4


def test_moe_block_bf16_combine_gives_jax_bits():
    """The combine on JAX's own expert outputs, weights and slots: K
    ordered adds in bf16 give ``segment_sum``'s bits on the CPU."""
    rng = np.random.default_rng(3)
    t, top_k, e, cap, d = 64, 6, 64, 12, 32
    out_e = rng.normal(size=(e, cap, d)).astype(ml_dtypes.bfloat16)
    topw = rng.dirichlet(np.ones(top_k), t).astype(np.float32)
    slot = rng.permutation(e * cap)[:t * top_k]                  # kept slots are unique
    slot[rng.random(t * top_k) < 0.2] = e * cap                  # some dropped
    keep = slot < e * cap
    # JAX's lines (repro/models/layers.py:275-278)
    out_flat = jnp.concatenate([jnp.asarray(out_e).reshape(e * cap, d),
                                jnp.zeros((1, d), jnp.bfloat16)])
    y = out_flat[slot] * (jnp.asarray(topw).reshape(-1)[:, None]
                          * jnp.asarray(keep)[:, None]).astype(jnp.bfloat16)
    want = np.asarray(jax.ops.segment_sum(y, jnp.repeat(jnp.arange(t), top_k),
                                          num_segments=t))
    got = layers.moe_combine(params_from_jax(out_e, "cpu"), torch.from_numpy(slot),
                             torch.from_numpy(topw), torch.from_numpy(keep))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def test_moe_block_bf16_matches_jax():
    """bf16 weights and input, f32 router (JAX promotes ``bf16 @ f32`` to an
    f32 product; torch would raise): the same routing, and the output within
    2^-5·max|y| (silu's rounding, see the module docstring)."""
    rng = np.random.default_rng(4)
    p = _moe_params()
    pb = {k: v if k == "router" else v.astype(ml_dtypes.bfloat16) for k, v in p.items()}
    x = rng.normal(size=(2, 16, D)).astype(ml_dtypes.bfloat16)
    (ty, taux, troute), (jy, jaux, jroute) = _both(pb, x, 1.0)
    for a, b in zip(troute, jroute):
        np.testing.assert_array_equal(a, b)
    assert ty.dtype == torch.bfloat16
    jy = jy.astype(np.float32)
    np.testing.assert_allclose(ty.float().numpy(), jy, rtol=0, atol=2 ** -5 * np.abs(jy).max())
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL)


def test_moe_block_padding_rows_compete_for_capacity():
    """T counts every row: zero rows (a wave's padding) take places in
    their experts as in JAX, so appending them changes the capacity and
    can change what the real rows keep."""
    rng = np.random.default_rng(5)
    x = np.zeros((4, 8, D), np.float32)
    x[:3] = rng.normal(size=(3, 8, D)) + 0.5
    p = _moe_params()
    got, want = _both(p, x, 0.5)
    _check_f32(got, want)
    assert layers.moe_capacity(32, K, E, 0.5) == 4 and not want[2][2].all()


# ---------------------------------------------------------------------------
# the reduced MoE configs
# ---------------------------------------------------------------------------


def _models(arch, mode="chunked", seed=4, **over):
    jcfg = dataclasses.replace(jax_reduced(arch), attn_mode=mode, **over)
    params = jax.device_get(jax_build(jcfg).init(jax.random.PRNGKey(seed)))
    tcfg = dataclasses.replace(get_reduced(arch), attn_mode=mode, **over)
    return jcfg, params, tcfg, params_from_jax(params, "cpu")


def test_init_lm_makes_jaxs_moe_tree():
    jcfg, params, tcfg, tp = _models("moonshot-v1-16b-a3b")
    ours = lm.init_lm(tcfg, torch.Generator("cpu").manual_seed(0))
    assert "mlp" not in ours["layers"]
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(tp)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(tp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert ours["layers"]["moe"]["w_gate"].shape == (2, 8, 128, 64)
    bf = lm.init_lm(dataclasses.replace(tcfg, dtype="bfloat16"),
                    torch.Generator("cpu").manual_seed(0))
    assert bf["layers"]["moe"]["router"].dtype == torch.float32
    assert bf["layers"]["moe"]["w_down"].dtype == torch.bfloat16


def test_stacked_init_draws_one_layer_at_a_time():
    """The experts' leaves are drawn per layer: the same values as drawing
    each layer's (E, D, F) in turn, cast into a leaf of the model's dtype."""
    got = layers.stacked_init(torch.Generator("cpu").manual_seed(3), (2,), (4, 8, 5),
                              torch.bfloat16)
    gen = torch.Generator("cpu").manual_seed(3)
    want = torch.stack([layers.dense_init(gen, (4, 8, 5), dtype=torch.bfloat16)
                        for _ in range(2)])
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("mode", ["pallas", "chunked"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_prefill_and_decode_match_jax(arch, mode):
    jcfg, params, tcfg, tp = _models(arch, mode)
    rng = np.random.default_rng(5)
    b, s, steps, cap = 2, 8, 4, 16
    toks = rng.integers(0, jcfg.vocab, (b, s + steps)).astype(np.int32)

    want, jaux = jlm.forward(params, jcfg, tokens=jnp.asarray(toks[:, :s]))
    got, aux = lm.forward(tp, tcfg, tokens=torch.from_numpy(toks[:, :s]))
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)
    assert float(aux) > 0

    jlogits, jcache = jlm.prefill(params, jcfg, tokens=jnp.asarray(toks[:, :s]),
                                  cache_capacity=cap)
    logits, cache = lm.prefill(tp, tcfg, tokens=torch.from_numpy(toks[:, :s]),
                               cache_capacity=cap)
    _close(logits, jlogits)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    for i in range(steps):  # teacher-forced
        step = toks[:, s + i:s + i + 1]
        jlogits, jcache = jlm.decode_step(params, jcfg, jcache, jnp.asarray(step))
        logits, cache = lm.decode_step(tp, tcfg, cache, torch.from_numpy(step))
        _close(logits, jlogits)
    _close(cache["k"], jcache["k"])
    assert cache["len"] == int(jcache["len"]) == s + steps


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_agrees_with_forward(arch):
    """Prefill + decode logits equal the full forward's at each position
    (``tests/test_models_smoke.py::test_decode_consistent_with_forward``;
    the reduced configs are drop-free, so the token count does not move
    the routing)."""
    _, _, tcfg, tp = _models(arch, "pallas")
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, tcfg.vocab, (1, 8)))
    full, _ = lm.forward(tp, tcfg, tokens=toks)
    pre, cache = lm.prefill(tp, tcfg, tokens=toks[:, :7], cache_capacity=8)
    _close(pre, full[:, 6])
    dec, _ = lm.decode_step(tp, tcfg, cache, toks[:, 7:])
    _close(dec, full[:, 7])


def _batch(cfg, b=4, s=16):
    batch = JaxTokenPipeline(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=5).batch_at(0)
    batch["mask"][:, -3:] = 0.0
    return batch


def _close_grads(tgrads, jgrads):
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    got = tree_leaves(tgrads)
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        g, w = g.detach().double().numpy(), np.asarray(w, np.float64)
        assert g.shape == w.shape
        gap = np.linalg.norm(g - w)
        assert gap <= GRAD_REL * np.linalg.norm(w) + 1e-12, \
            f"{jax.tree_util.keystr(path)}: ‖Δ‖ {gap:.3g}, ‖g‖ {np.linalg.norm(w):.3g}"


@pytest.mark.parametrize("cf", [None, 1.0], ids=["config", "drops"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_gradients_match_jax(arch, cf):
    """``lm_loss`` (chunked CE + moe_aux_weight · aux) and its gradients,
    remat on, against ``jax.value_and_grad``; under capacity 1.0 too,
    where choices are dropped."""
    over = {"remat": True, "loss_chunk": 8}
    if cf is not None:
        over["moe_capacity_factor"] = cf
    jcfg, params, tcfg, tp = _models(arch, **over)
    batch = _batch(tcfg)
    jloss, jgrads = jax.value_and_grad(jax_build(jcfg).loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = value_and_grad(build_model(tcfg).loss, tp,
                                   {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    _close_grads(tgrads, jgrads)
    router = tgrads["layers"]["moe"]["router"]
    assert router.dtype == torch.float32 and float(router.abs().max()) > 0


def test_moe_loss_adds_the_aux_loss():
    _, _, tcfg, tp = _models("moonshot-v1-16b-a3b")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in _batch(tcfg).items()}
    with torch.no_grad():
        full = build_model(tcfg).loss(tp, batch)
        ce = build_model(dataclasses.replace(tcfg, moe_aux_weight=0.0)).loss(tp, batch)
        _, aux = lm.forward(tp, tcfg, tokens=batch["tokens"])
    torch.testing.assert_close(full - ce, tcfg.moe_aux_weight * aux, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_steps_lower_the_loss(arch):
    _, _, tcfg, tp = _models(arch, remat=True)
    model = build_model(tcfg)
    step, opt = make_train_step(model, AdamW(lr=3e-3))
    state = opt.init(tp)
    batch = {k: torch.from_numpy(v)
             for k, v in TokenPipeline(vocab=tcfg.vocab, seq_len=16, global_batch=4)
             .batch_at(0).items()}
    losses = []
    for _ in range(3):
        tp, state, met = step(tp, state, batch)
        losses.append(float(met["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert tp["layers"]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("arch,cf", [("moonshot-v1-16b-a3b", 1.0), ("mixtral-8x7b", None)],
                         ids=["moonshot-drops", "mixtral"])
def test_served_moe_wave_gives_jax_greedy_tokens(arch, cf):
    """One wave of 3 prompts padded to 4 rows: the JAX launcher's prefill,
    greedy token and jitted serve steps against ``make_run_wave``; under
    capacity 1.0 the padding row competes for places, as in JAX."""
    over = {} if cf is None else {"moe_capacity_factor": cf}
    jcfg, params, tcfg, tp = _models(arch, "pallas", seed=7, **over)
    batch, plen, gen, cap = 4, 8, 6, 16
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab, (3, plen))
    toks = np.zeros((batch, plen), np.int32)
    toks[:3] = prompts
    logits, state = jlm.prefill(params, jcfg, tokens=jnp.asarray(toks), cache_capacity=cap)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    serve = jax.jit(jax_serve_step(jax_build(jcfg)))
    want = np.zeros((batch, gen), np.int32)
    for i in range(gen):
        tok, _, state = serve(params, state, tok)
        want[:, i] = np.asarray(tok[:, 0])

    run_wave = make_run_wave(build_model(tcfg), tp, batch=batch, prompt_len=plen, gen=gen,
                             cache_cap=cap, device="cpu")
    got = run_wave([Request(rid=10 + i, prompt=prompts[i]) for i in range(3)])
    assert sorted(got) == [10, 11, 12]
    for i in range(3):
        np.testing.assert_array_equal(got[10 + i], want[i])


# ---------------------------------------------------------------------------
# carrying weights across
# ---------------------------------------------------------------------------


def test_params_from_jax_keeps_the_router_f32():
    """A bf16 carry of an MoE tree leaves the router f32 (bf16 would route
    other experts); f64 carries it at f64; every other leaf takes the
    dtype given."""
    jcfg = jax_reduced("moonshot-v1-16b-a3b")
    params = jax.device_get(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    bf = params_from_jax(params, "cpu", torch.bfloat16)
    assert bf["layers"]["moe"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(bf["layers"]["moe"]["router"].numpy(),
                                  params["layers"]["moe"]["router"])
    others = [t for k, t in bf["layers"]["moe"].items() if k != "router"]
    assert all(t.dtype == torch.bfloat16 for t in others + [bf["emb"]])
    f64 = params_from_jax(params, "cpu", torch.float64)
    assert f64["layers"]["moe"]["router"].dtype == torch.float64
    assert params_from_jax(params, "cpu")["layers"]["moe"]["router"].dtype == torch.float32


def test_bf16_moe_model_routes_with_an_f32_router():
    """The reduced Moonlight in bf16, carried from JAX's bf16 init: the
    router stays f32 and the forward runs (a bf16 × f32 product in torch
    would raise)."""
    jcfg = dataclasses.replace(jax_reduced("moonshot-v1-16b-a3b"), dtype="bfloat16")
    params = jax.device_get(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    assert params["layers"]["moe"]["router"].dtype == np.float32
    tp = params_from_jax(params, "cpu", torch.bfloat16)
    tcfg = dataclasses.replace(get_reduced("moonshot-v1-16b-a3b"), dtype="bfloat16")
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 8)).astype(np.int32)
    got, aux = lm.forward(tp, tcfg, tokens=torch.from_numpy(toks))
    want, jaux = jlm.forward(params, jcfg, tokens=jnp.asarray(toks))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-2)
