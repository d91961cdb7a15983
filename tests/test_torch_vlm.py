"""The port's VLM family (Qwen2-VL's M-RoPE backbone) against the JAX
package's, on the CPU.

Inputs are numpy arrays from a seed: stub patch embeddings (B, S, D) and
three position streams (t, h, w) that differ from one another, shaped like
an image grid followed by text.  With the broadcast arange that JAX's
launcher and tests use, the three streams are equal and M-RoPE is plain
RoPE, so no test would see a wrong section; these streams would.

Tolerances: ``apply_mrope`` rtol/atol 1e-5 (f32 sin/cos of the same
angles); the reduced config's logits and caches rtol/atol 2e-3
(``tests/test_models_smoke.py``); the loss rtol 1e-5 and each gradient
leaf ‖Δ‖ ≤ 1e-4·‖g‖; batches and served tokens exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro.launch.train import make_batch_fn as jax_batch_fn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.api import make_serve_step as jax_serve_step  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.serve import Request, make_run_wave  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.models.api import build_model, value_and_grad  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

ARCH = "qwen2-vl-7b"
TOL = 2e-3
RTOL = 1e-5
GRAD_REL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def image_then_text(b: int, s: int, grid: int) -> np.ndarray:
    """positions3 (3, B, S): a grid × grid patch image (t = 0, h = row,
    w = col), then text whose three streams continue together from the
    grid's largest position + 1."""
    pos = np.zeros((3, b, s), np.int32)
    n = min(grid * grid, s)
    idx = np.arange(n)
    pos[1, :, :n] = idx // grid
    pos[2, :, :n] = idx % grid
    text = np.arange(s - n, dtype=np.int32) + (grid - 1) + 1
    pos[:, :, n:] = text
    return pos


def _models(mode="chunked", seed=4, **over):
    jcfg = dataclasses.replace(jax_reduced(ARCH), attn_mode=mode, **over)
    params = jax.device_get(jax_build(jcfg).init(jax.random.PRNGKey(seed)))
    tcfg = dataclasses.replace(get_reduced(ARCH), attn_mode=mode, **over)
    return jcfg, params, tcfg, params_from_jax(params, "cpu")


def _inputs(cfg, b=2, s=16, grid=3, seed=6):
    rng = np.random.default_rng(seed)
    embeds = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return embeds, image_then_text(b, s, grid)


def test_image_then_text_positions_have_three_streams():
    pos = image_then_text(1, 12, 3)
    assert pos[:, 0, :9].tolist() == [[0] * 9, [0, 0, 0, 1, 1, 1, 2, 2, 2],
                                      [0, 1, 2, 0, 1, 2, 0, 1, 2]]
    assert pos[:, 0, 9:].tolist() == [[3, 4, 5]] * 3


@pytest.mark.parametrize("sections,d", [((16, 24, 24), 128), ((4, 6, 6), 32), ((2, 3, 5), 32),
                                        ((8, 8, 8), 32)],
                         ids=["qwen2-vl-7b", "reduced", "short", "long"])
def test_apply_mrope_matches_jax_with_three_streams(sections, d):
    """Three distinct position streams through the sections; sections that
    sum short of D/2 or past it follow ``jnp.repeat``'s
    ``total_repeat_length`` (pad with the last stream, or cut)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 11, d)).astype(np.float32)
    pos3 = rng.integers(0, 3000, (3, 2, 11)).astype(np.int32)
    assert len({tuple(p.ravel()) for p in pos3}) == 3
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), sections, 1e6)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), sections, 1e6)
    _close(got, want, 1e-5)
    # each section really takes its own stream: equal streams give plain RoPE
    same = np.broadcast_to(pos3[:1], pos3.shape).copy()
    rope = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos3[0]), 1e6)
    _close(layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(same), sections, 1e6),
           rope, 1e-5)
    assert not torch.allclose(got, rope)


@pytest.mark.parametrize("mode", ["pallas", "chunked"])
def test_vlm_forward_and_prefill_match_jax(mode):
    jcfg, params, tcfg, tp = _models(mode)
    embeds, pos3 = _inputs(tcfg)
    want, jaux = jlm.forward(params, jcfg, embeds=jnp.asarray(embeds),
                             positions3=jnp.asarray(pos3))
    got, aux = lm.forward(tp, tcfg, embeds=torch.from_numpy(embeds),
                          positions3=torch.from_numpy(pos3))
    _close(got, want)
    assert float(aux) == float(jaux) == 0.0

    cap = 20
    jlogits, jcache = jlm.prefill(params, jcfg, embeds=jnp.asarray(embeds),
                                  positions3=jnp.asarray(pos3), cache_capacity=cap)
    logits, cache = lm.prefill(tp, tcfg, embeds=torch.from_numpy(embeds),
                               positions3=torch.from_numpy(pos3), cache_capacity=cap)
    _close(logits, jlogits)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    _close(logits, got[:, -1])


def test_vlm_prefill_defaults_to_the_broadcast_arange():
    jcfg, params, tcfg, tp = _models()
    embeds, _ = _inputs(tcfg)
    jlogits, jcache = jlm.prefill(params, jcfg, embeds=jnp.asarray(embeds))
    logits, cache = lm.prefill(tp, tcfg, embeds=torch.from_numpy(embeds))
    _close(logits, jlogits)
    _close(cache["k"], jcache["k"])
    arange = np.broadcast_to(np.arange(16, dtype=np.int32), (3, 2, 16))
    again, _ = lm.prefill(tp, tcfg, embeds=torch.from_numpy(embeds),
                          positions3=torch.from_numpy(arange.copy()))
    assert torch.equal(again, logits)


def test_vlm_decode_rotates_with_1d_rope_as_jax_does():
    """The kept quirk (ROADMAP Queue 3): ``decode_step`` passes no M-RoPE
    sections, so a VLM's decode step rotates q and k with 1-D RoPE at
    ``cache_len`` whatever streams the prefill used.  The port's decode
    matches JAX's, and equals a decode of the same model with M-RoPE off."""
    jcfg, params, tcfg, tp = _models()
    embeds, pos3 = _inputs(tcfg)
    toks = np.random.default_rng(8).integers(0, tcfg.vocab, (2, 3)).astype(np.int32)
    jlogits, jcache = jlm.prefill(params, jcfg, embeds=jnp.asarray(embeds),
                                  positions3=jnp.asarray(pos3), cache_capacity=20)
    logits, cache = lm.prefill(tp, tcfg, embeds=torch.from_numpy(embeds),
                               positions3=torch.from_numpy(pos3), cache_capacity=20)
    plain_cfg = dataclasses.replace(tcfg, mrope_sections=None)
    plain_cache = {k: v.clone() if torch.is_tensor(v) else v for k, v in cache.items()}
    for i in range(3):
        step = toks[:, i:i + 1]
        jlogits, jcache = jlm.decode_step(params, jcfg, jcache, jnp.asarray(step))
        logits, cache = lm.decode_step(tp, tcfg, cache, torch.from_numpy(step))
        plain, plain_cache = lm.decode_step(tp, plain_cfg, plain_cache, torch.from_numpy(step))
        _close(logits, jlogits)
        assert torch.equal(logits, plain)
    _close(cache["k"], jcache["k"])
    assert cache["len"] == int(jcache["len"]) == 19


def test_vlm_loss_and_gradients_match_jax():
    """``lm_loss`` with embeds and positions3 in the batch, remat on."""
    jcfg, params, tcfg, tp = _models(remat=True, loss_chunk=8)
    embeds, pos3 = _inputs(tcfg, b=4)
    pipe = JaxTokenPipeline(vocab=tcfg.vocab, seq_len=16, global_batch=4, seed=5).batch_at(0)
    batch = {"embeds": embeds, "positions3": pos3, "labels": pipe["labels"],
             "mask": pipe["mask"]}
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
        gap = np.linalg.norm(g - w)
        assert gap <= GRAD_REL * np.linalg.norm(w) + 1e-12, jax.tree_util.keystr(path)


def test_vlm_batch_fn_is_jaxs():
    """The launcher's vlm batch: stub embeddings from
    ``default_rng((1234, step))``, the broadcast arange, no tokens."""
    cfg = get_reduced(ARCH)
    jbatch = jax_batch_fn(jax_reduced(ARCH), JaxTokenPipeline(
        vocab=cfg.vocab, seq_len=8, global_batch=2))(3)
    batch = train_mod.make_batch_fn(cfg, TokenPipeline(vocab=cfg.vocab, seq_len=8,
                                                       global_batch=2), "cpu")(3)
    assert sorted(batch) == sorted(jbatch) == ["embeds", "labels", "mask", "positions3"]
    for k, v in jbatch.items():
        assert batch[k].dtype == getattr(torch, str(v.dtype)), k
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v), err_msg=k)


def test_vlm_train_batch_runs_the_loss():
    cfg = get_reduced(ARCH)
    batch = train_mod.make_batch_fn(cfg, TokenPipeline(vocab=cfg.vocab, seq_len=8,
                                                       global_batch=2), "cpu")(0)
    model = build_model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    with torch.no_grad():
        assert np.isfinite(float(model.loss(params, batch)))


def test_vlm_serve_wave_decodes_from_an_empty_cache_as_jax():
    """The JAX launcher's ``else`` branch for the vlm family: no prefill,
    ``init_state``'s empty cache and a zero token, then greedy steps; the
    prompts are not read (a kept quirk, ROADMAP Queue 3)."""
    jcfg, params, tcfg, tp = _models("pallas", seed=7)
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
