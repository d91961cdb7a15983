"""The port's hybrid family (Zamba2: Mamba2 layers and one shared attention
block) against the JAX package's, on the CPU.

The reduced Zamba2 has 5 layers with the shared block every 2, so JAX's
prefill and decode run 2 full groups and a tail of 1; the ``no_tail``
variant has 4 layers (2 groups, no tail).  A ``d_head = 112`` variant puts
Zamba2-7B's head width through the attention, so that the port's
``flash_attention`` at D = 112 (its plain version on the CPU) meets JAX's
``flash_attention_p`` in interpret mode.  Weights are drawn by JAX (the
Mamba decays, zeros and ones at init, then set to seeded values) and
carried by ``params_from_jax``; tokens are numpy-seeded.

Tolerances: prefill logits, every state leaf and decode steps at rtol/atol
2e-3 (``tests/test_models_smoke.py``); the loss at rtol 1e-5 and each
gradient leaf ‖Δ‖ ≤ 1e-4·‖g‖; served tokens exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.api import make_serve_step as jax_serve_step  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.serve import Request, make_run_wave  # noqa: E402
from repro_torch.models import hybrid  # noqa: E402
from repro_torch.models.api import build_model, value_and_grad  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

ARCH = "zamba2-7b"
TOL = 2e-3
RTOL = 1e-5
GRAD_REL = 1e-4
#: the reduced config (5 layers: 2 groups of 2 and a tail of 1), one with
#: no tail, and one at Zamba2-7B's attention head width
VARIANTS = {"tail": {}, "no_tail": {"n_layers": 4},
            "d_head_112": {"d_head": 112, "n_heads": 2, "n_kv_heads": 2}}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _models(variant="tail", mode="chunked", seed=4, **over):
    over = {**VARIANTS[variant], **over}
    jcfg = dataclasses.replace(jax_reduced(ARCH), attn_mode=mode, **over)
    params = jax.device_get(jax_build(jcfg).init(jax.random.PRNGKey(seed)))
    mamba = params["layers"]["mamba"]
    rng = np.random.default_rng(seed)
    for name, (mu, sd) in (("A_log", (0.0, 0.5)), ("D", (1.0, 0.3)), ("dt_bias", (0.0, 0.5))):
        mamba[name] = rng.normal(mu, sd, mamba[name].shape).astype(np.float32)
    tcfg = dataclasses.replace(get_reduced(ARCH), attn_mode=mode, **over)
    return jcfg, params, tcfg, params_from_jax(params, "cpu")


def test_reduced_configs_split_as_intended():
    for variant, (full, rem, points) in (("tail", (2, 1, 3)), ("no_tail", (2, 0, 2))):
        cfg = dataclasses.replace(get_reduced(ARCH), **VARIANTS[variant])
        ae = cfg.attn_every
        assert (cfg.n_layers // ae, cfg.n_layers % ae, cfg.n_attn_points) == (full, rem, points)
    assert dataclasses.replace(get_reduced(ARCH), **VARIANTS["d_head_112"]).d_head == 112


@pytest.mark.parametrize("mode", ["chunked", "ref", "pallas"])
@pytest.mark.parametrize("variant", ["tail", "no_tail"])
def test_hybrid_prefill_and_decode_match_jax(variant, mode):
    """Prefill's logits and every state leaf (conv, SSM, the KV cache of
    each attention point, len), then 4 greedy decode steps."""
    jcfg, params, tcfg, tp = _models(variant, mode)
    _prefill_and_decode(jcfg, params, tcfg, tp)


def test_hybrid_prefill_and_decode_at_d_head_112_meet_the_pallas_kernel():
    """attn_mode "pallas" at D = 112: JAX's flash_attention_p in interpret
    mode against the port's flash_attention (its plain version here)."""
    jcfg, params, tcfg, tp = _models("d_head_112", "pallas")
    _prefill_and_decode(jcfg, params, tcfg, tp)


def _prefill_and_decode(jcfg, params, tcfg, tp, b=2, s=16, cap=24, steps=4):
    jm, tm = jax_build(jcfg), build_model(tcfg)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (b, s)).astype(np.int32)
    jl, jst = jm.prefill(params, {"tokens": jnp.asarray(toks)}, cap)
    tl, tst = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cap)
    _close(tl, jl)
    _close_state(tst, jst)
    assert tst["k"].shape == (tcfg.n_attn_points, b, tcfg.n_kv_heads, cap, tcfg.d_head)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for _ in range(steps):
        jl, jst = jm.decode(params, jst, jnp.asarray(tok))
        tl, tst = tm.decode(tp, tst, torch.from_numpy(tok))
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    _close_state(tst, jst)
    assert tst["len"] == int(jst["len"]) == s + steps


def _close_state(got, want):
    assert sorted(got) == sorted(want)
    for key in ("conv", "ssm", "k", "v"):
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype)[6:] == str(want[key].dtype), key
        _close(got[key], want[key])
    assert got["len"] == int(want["len"])


def test_hybrid_prefill_launches_the_kernel_once_per_attention_point():
    """attn_mode "pallas" routes the shared block's prefill through
    ``ops.flash_attention`` once per attention point (3 here; 14 at
    Zamba2-7B); decode calls it not at all."""
    _, _, tcfg, tp = _models("tail", "pallas")
    calls = []
    original = ops.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return original(*a, **kw)

    ops.flash_attention = counted
    try:
        model = build_model(tcfg)
        _, st = model.prefill(tp, {"tokens": torch.zeros((2, 8), dtype=torch.int32)}, 12)
        assert len(calls) == tcfg.n_attn_points == 3
        model.decode(tp, st, torch.zeros((2, 1), dtype=torch.int32))
        assert len(calls) == 3
    finally:
        ops.flash_attention = original
    assert calls[0] == (2, tcfg.n_heads, 8, tcfg.d_head)


def test_hybrid_decode_after_prefill_matches_a_longer_prefill():
    _, _, tcfg, tp = _models("tail")
    model = build_model(tcfg)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, tcfg.vocab, (2, 8))
                            .astype(np.int32))
    _, state = model.prefill(tp, {"tokens": toks[:, :7]}, 8)
    logits, state = model.decode(tp, state, toks[:, 7:])
    want, want_state = model.prefill(tp, {"tokens": toks}, 8)
    _close(logits, want)
    for key in ("conv", "ssm", "k", "v"):
        _close(state[key], want_state[key])


def test_hybrid_init_makes_jaxs_tree():
    """The port's tree is JAX's, leaf for leaf (shapes and dtypes; the
    Mamba decays f32 in a bf16 model)."""
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jax_reduced(ARCH), dtype=dtype)
        want = jax.eval_shape(lambda k: jax_build(jcfg).init(k), jax.random.PRNGKey(0))
        tcfg = dataclasses.replace(get_reduced(ARCH), dtype=dtype)
        got = hybrid.init_hybrid(tcfg, torch.Generator("cpu").manual_seed(0))
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype)


def test_init_state_is_jaxs():
    cfg = get_reduced(ARCH)
    want = jax_build(jax_reduced(ARCH)).init_state(3, 10)
    got = build_model(cfg).init_state(3, 10)
    _close_state(got, want)


@pytest.mark.parametrize("variant", ["tail", "no_tail"])
def test_hybrid_loss_and_gradients_match_jax(variant):
    """``lm_loss`` with remat on (each layer under a checkpoint)."""
    jcfg, params, tcfg, tp = _models(variant, remat=True, loss_chunk=8)
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


def test_hybrid_remat_gives_the_same_loss_and_gradients():
    _, _, tcfg, tp = _models("tail", loss_chunk=8)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in JaxTokenPipeline(
        vocab=tcfg.vocab, seq_len=16, global_batch=2, seed=6).batch_at(0).items()}
    runs = [value_and_grad(build_model(dataclasses.replace(tcfg, remat=r)).loss, tp, batch)
            for r in (False, True)]
    (l0, g0), (l1, g1) = runs
    assert float(l0) == float(l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_hybrid_serve_wave_decodes_from_an_empty_state_as_jax():
    """The JAX launcher's ``else`` branch for the hybrid family: no
    prefill, ``init_state``'s empty state and a zero token, then greedy
    steps; the prompts are not read (a kept quirk, ROADMAP Queue 3 item
    25)."""
    jcfg, params, tcfg, tp = _models("tail", "pallas", seed=7)
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
    rng = np.random.default_rng(0)
    for prompts in (rng.integers(0, jcfg.vocab, (3, plen)), np.zeros((3, plen), np.int64)):
        got = run_wave([Request(rid=10 + i, prompt=prompts[i]) for i in range(3)])
        assert sorted(got) == [10, 11, 12]
        for i in range(3):
            np.testing.assert_array_equal(got[10 + i], want[i])


def test_hybrid_serve_cli_on_the_cpu():
    outputs = serve_mod.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
                              "--batch", "2", "--gen", "3", "--prompt-len", "4",
                              "--attn-mode", "pallas"])
    assert sorted(outputs) == [0, 1, 2] and all(t.shape == (3,) for t in outputs.values())


def test_hybrid_trains_two_steps_from_the_launcher(tmp_path):
    """The launcher's token batches run the hybrid loss: 2 AdamW steps on
    the reduced config, finite losses."""
    args = train_mod.parse_args(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                                 "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    _, losses = train_mod.run(args)
    assert len(losses) == 2 and all(np.isfinite(losses))
