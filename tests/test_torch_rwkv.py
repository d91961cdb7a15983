"""The port's RWKV6 family against the JAX package's, on the CPU.

Weights are drawn by JAX and carried by ``params_from_jax``; inputs and
tokens are numpy arrays from a seed.  Tolerances: the time mix and
channel mix in f32 at rtol 1e-5 (atol 1e-6·max|y|: the time scan's f32
sums); the reduced RWKV6's loss at rtol 1e-5 and each gradient leaf
‖Δ‖ ≤ 1e-4·‖g‖; prefill logits, every state leaf and decode steps at
rtol/atol 2e-3 (``tests/test_models_smoke.py``); served tokens exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.api import make_serve_step as jax_serve_step  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.serve import Request, make_run_wave  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.api import build_model, value_and_grad  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

ARCH = "rwkv6-1.6b"
TOL = 2e-3
RTOL = 1e-5
GRAD_REL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_f32(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=1e-6 * float(np.abs(want).max()))


def _models(seed=4, **over):
    jcfg = dataclasses.replace(jax_reduced(ARCH), **over)
    params = jax.device_get(jax_build(jcfg).init(jax.random.PRNGKey(seed)))
    tcfg = dataclasses.replace(get_reduced(ARCH), **over)
    return jcfg, params, tcfg, params_from_jax(params, "cpu")


def _layer0(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[0], params["layers"]["tm"])


def _mix_state(rng, b, d, h):
    last = rng.normal(size=(b, 1, d)).astype(np.float32)
    wkv = rng.normal(size=(b, h, 64, 64)).astype(np.float32)
    return last, wkv


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_time_mix_matches_jax(with_state):
    _, params, tcfg, _ = _models()
    lp = _layer0(params)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, tcfg.d_model)).astype(np.float32)
    jst = tst = None
    if with_state:
        last, wkv = _mix_state(rng, 2, tcfg.d_model, tcfg.d_model // 64)
        jst = (jnp.asarray(last), jnp.asarray(wkv))
        tst = (torch.from_numpy(last), torch.from_numpy(wkv))
    jy, (jlast, jwkv) = jssm.rwkv6_time_mix(lp, jnp.asarray(x), state=jst)
    ty, (tlast, twkv) = ssm.rwkv6_time_mix(params_from_jax(lp, "cpu"), torch.from_numpy(x),
                                           state=tst)
    _close_f32(ty, jy)
    _close_f32(twkv, jwkv)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_channel_mix_matches_jax(with_state):
    _, params, tcfg, _ = _models()
    lp = _layer0(params)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, tcfg.d_model)).astype(np.float32)
    last = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32) if with_state else None
    jy, jlast = jssm.rwkv6_channel_mix(lp, jnp.asarray(x),
                                       None if last is None else jnp.asarray(last))
    ty, tlast = ssm.rwkv6_channel_mix(params_from_jax(lp, "cpu"), torch.from_numpy(x),
                                      None if last is None else torch.from_numpy(last))
    _close_f32(ty, jy)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))


def test_time_mix_keeps_f64_in_f64():
    """An f64 model's scan runs in f64 (the card's yardstick; JAX casts to
    f32, ROADMAP Queue 3 item 28); its f32 run is within f32's rounding."""
    _, params, tcfg, _ = _models()
    lp = params_from_jax(_layer0(params), "cpu")
    lp64 = {k: v.double() for k, v in lp.items()}
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 7, tcfg.d_model)))
    y64, (_, s64) = ssm.rwkv6_time_mix(lp64, x)
    y32, (_, s32) = ssm.rwkv6_time_mix(lp, x.float())
    assert s64.dtype == torch.float64 and s32.dtype == torch.float32
    gap = float(torch.linalg.vector_norm(y32.double() - y64) / torch.linalg.vector_norm(y64))
    assert 0 < gap <= 1e-5


def test_init_rwkv_lm_makes_jaxs_tree():
    """The port's tree is JAX's, leaf for leaf (shapes and dtypes; the
    channel mix's leaves inside ``tm``), so ``params_from_jax`` carries it
    unchanged; w0 and u are f32 in a bf16 model."""
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jax_reduced(ARCH), dtype=dtype)
        want = jax.eval_shape(lambda k: jax_build(jcfg).init(k), jax.random.PRNGKey(0))
        tcfg = dataclasses.replace(get_reduced(ARCH), dtype=dtype)
        got = ssm.init_rwkv_lm(tcfg, torch.Generator("cpu").manual_seed(0))
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype)
    assert "cm_k" in got["layers"]["tm"] and got["layers"]["tm"]["u"].dtype == torch.float32


def test_rwkv_prefill_and_decode_match_jax():
    """Prefill's logits and every state leaf, then 4 greedy decode steps
    from that state."""
    jcfg, params, tcfg, tp = _models(seed=5)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (3, 9)).astype(np.int32)
    jl, jst = jm.prefill(params, {"tokens": jnp.asarray(toks)}, 16)
    tl, tst = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 16)
    _close(tl, jl)
    got, want = tree_leaves(tst), jax.tree_util.tree_leaves(jst)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for _ in range(4):
        jl, jst = jm.decode(params, jst, jnp.asarray(tok))
        tl, tst = tm.decode(tp, tst, torch.from_numpy(tok))
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for g, w in zip(tree_leaves(tst), jax.tree_util.tree_leaves(jst)):
        _close(g, w)


def test_rwkv_decode_after_prefill_matches_a_longer_prefill():
    """A prefill of S tokens then one decode step gives the logits of a
    prefill of S + 1, and the same state."""
    _, _, tcfg, tp = _models(seed=6)
    model = build_model(tcfg)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, tcfg.vocab, (2, 8))
                            .astype(np.int32))
    _, state = model.prefill(tp, {"tokens": toks[:, :7]}, 8)
    logits, state = model.decode(tp, state, toks[:, 7:])
    want, want_state = model.prefill(tp, {"tokens": toks}, 8)
    _close(logits, want)
    for g, w in zip(tree_leaves(state), tree_leaves(want_state)):
        _close(g, w)


def test_rwkv_decode_from_empty_state_matches_the_backbone():
    """``tests/test_models_smoke.py``'s check in the port: token-by-token
    decode from ``init_state`` gives the full backbone's last logits."""
    _, _, tcfg, tp = _models(seed=6)
    model = build_model(tcfg)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, tcfg.vocab, (1, 6))
                            .astype(np.int32))
    xf, _ = ssm.rwkv_backbone(tp, tcfg, tp["emb"][toks])
    want = xf[:, -1].float() @ tp["emb"].float().T
    state = model.init_state(1, 6)
    for i in range(6):
        logits, state = model.decode(tp, state, toks[:, i:i + 1])
    _close(logits, want)


def test_rwkv_loss_and_gradients_match_jax():
    """``rwkv_lm_loss`` with remat on (each layer under a checkpoint)."""
    jcfg, params, tcfg, tp = _models(remat=True, loss_chunk=8)
    batch = JaxTokenPipeline(vocab=tcfg.vocab, seq_len=16, global_batch=2, seed=5).batch_at(0)
    batch["mask"][:, -3:] = 0.0
    jloss, jgrads = jax.value_and_grad(jax_build(jcfg).loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = value_and_grad(build_model(tcfg).loss, tp,
                                   {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    got = tree_leaves(tgrads)
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        g, w = g.double().numpy(), np.asarray(w, np.float64)
        assert np.linalg.norm(g - w) <= GRAD_REL * np.linalg.norm(w) + 1e-12, \
            jax.tree_util.keystr(path)


def test_rwkv_serve_wave_decodes_from_an_empty_state_as_jax():
    """The JAX launcher's ``else`` branch for the rwkv family: no prefill,
    ``init_state``'s empty state and a zero token, then greedy steps; the
    prompts are not read (a kept quirk, ROADMAP Queue 3 item 25)."""
    jcfg, params, tcfg, tp = _models(seed=7)
    batch, plen, gen, cap = 4, 8, 6, 16
    jmodel = jax_build(jcfg)
    state = jmodel.init_state(batch, cap)
    tok = jnp.zeros((batch, 1), jnp.int32)
    serve = jax.jit(jax_serve_step(jmodel))
    want = np.zeros((batch, gen), np.int32)
    for i in range(gen):
        tok, _, state = serve(params, state, tok)
        want[:, i] = np.asarray(tok[:, 0])
    run_wave = make_run_wave(build_model(tcfg), tp, batch=batch, prompt_len=plen, gen=gen,
                             cache_cap=cap, device="cpu")
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab, (3, plen))
    got = run_wave([Request(rid=10 + i, prompt=prompts[i]) for i in range(3)])
    assert sorted(got) == [10, 11, 12]
    for i in range(3):
        np.testing.assert_array_equal(got[10 + i], want[i])


def test_bf16_rwkv_at_full_depth_stays_within_the_cards_bound_of_f64():
    """``chip_smoke.py`` holds RWKV6-1.6B in bf16 to the same weights in
    f64 by the RMS of the logits' difference, at most 0.15 of their std
    (bf16 rounds every product and the residual stream to 8 bits).  Here
    the same bound at the full 24 layers of random weights, narrower."""
    cfg = dataclasses.replace(get_reduced(ARCH), n_layers=24, d_model=256, d_ff=896,
                              vocab=4096)
    params = build_model(cfg).init(torch.Generator("cpu").manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 64)))
    out = {}
    for dtype in ("bfloat16", "float64"):
        m = build_model(dataclasses.replace(cfg, dtype=dtype))
        tree = jax.tree_util.tree_map(lambda t: t.to(getattr(torch, dtype)), params)
        with torch.inference_mode():
            out[dtype] = m.prefill(tree, {"tokens": toks}, 64)[0].double()
    want = out["float64"]
    rms = float((out["bfloat16"] - want).pow(2).mean().sqrt())
    assert 0 < rms <= 0.15 * float(want.std())


def test_rwkv_serve_cli_on_the_cpu():
    outputs = serve_mod.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
                              "--batch", "2", "--gen", "3", "--prompt-len", "4"])
    assert sorted(outputs) == [0, 1, 2] and all(t.shape == (3,) for t in outputs.values())


def test_rwkv_trains_two_steps_from_the_launcher(tmp_path):
    """The launcher's token batches run the rwkv loss: 2 AdamW steps on the
    reduced config, finite losses."""
    args = train_mod.parse_args(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                                 "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path)])
    _, losses = train_mod.run(args)
    assert len(losses) == 2 and all(np.isfinite(losses))
