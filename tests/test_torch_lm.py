"""The port's LM substrate against the JAX package's, on the CPU.

Reduced configs in f32.  JAX initialises the parameters; the QKV biases
are then set to random values (JAX makes them zero, which would leave
that path untested), and ``params_from_jax`` carries the tree across.
Forward logits, prefill logits and cache, and teacher-forced decode steps
are held to JAX at rtol/atol 2e-3 (``tests/test_models_smoke.py``), with
the port's attention as the kernel's plain version (``pallas``) and as
``chunked``; one served wave of each dense config gives JAX's greedy
tokens exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.api import make_serve_step as jax_serve_step  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import Request, make_run_wave  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.models.api import build_model, make_serve_step  # noqa: E402

TOL = 2e-3


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _models(arch, mode, seed=4):
    """(JAX cfg, JAX params, port cfg, port params) with random QKV biases."""
    jcfg = dataclasses.replace(jax_reduced(arch), attn_mode=mode)
    params = jax.device_get(jax_build(jcfg).init(jax.random.PRNGKey(seed)))
    attn = params["layers"]["attn"]
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = rng.normal(0, 0.5, attn[name].shape).astype(np.float32)
    tcfg = dataclasses.replace(get_reduced(arch), attn_mode=mode)
    return jcfg, params, tcfg, params_from_jax(params, "cpu")


def test_configs_are_the_jax_configs():
    from repro.configs import get_config as jax_config

    for arch in ARCH_IDS:
        for mine, theirs in ((get_config(arch), jax_config(arch)),
                             (get_reduced(arch), jax_reduced(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert get_config("qwen2-1.5b").param_dtype == torch.bfloat16


def test_params_from_jax_keeps_the_tree():
    jcfg, params, tcfg, tp = _models("qwen2-1.5b", "chunked")
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == 14  # emb, final_norm, 7 attention, 2 norms, 3 mlp
    for path, leaf in flat:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), leaf)
    assert tp["layers"]["attn"]["wq"].shape == (jcfg.n_layers, jcfg.d_model,
                                                jcfg.n_heads * jcfg.d_head)
    ours = lm.init_lm(tcfg, torch.Generator("cpu").manual_seed(0))
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(tp)
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(ours),
                                                  jax.tree_util.tree_leaves(tp)))


def test_params_from_jax_carries_bf16_bits():
    a = np.random.default_rng(0).normal(size=(3, 5)).astype(ml_dtypes.bfloat16)
    t = params_from_jax({"w": a}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    assert params_from_jax({"w": a}, "cpu", torch.float32)["w"].dtype == torch.float32


@pytest.mark.parametrize("mode", ["pallas", "chunked"])
def test_qwen2_forward_prefill_and_decode_match_jax(mode):
    jcfg, params, tcfg, tp = _models("qwen2-1.5b", mode)
    rng = np.random.default_rng(5)
    b, s, steps, cap = 2, 8, 4, 16
    toks = rng.integers(0, jcfg.vocab, (b, s + steps)).astype(np.int32)

    want, jaux = jlm.forward(params, jcfg, tokens=jnp.asarray(toks[:, :s]))
    got, aux = lm.forward(tp, tcfg, tokens=torch.from_numpy(toks[:, :s]))
    _close(got, want)
    assert float(aux) == float(jaux) == 0.0  # a dense model has no aux loss

    jlogits, jcache = jlm.prefill(params, jcfg, tokens=jnp.asarray(toks[:, :s]),
                                  cache_capacity=cap)
    logits, cache = lm.prefill(tp, tcfg, tokens=torch.from_numpy(toks[:, :s]),
                               cache_capacity=cap)
    _close(logits, jlogits)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    assert cache["len"] == int(jcache["len"]) == s
    assert cache["k"].shape == (tcfg.n_layers, b, tcfg.n_kv_heads, cap, tcfg.d_head)

    for i in range(steps):  # teacher-forced
        step = toks[:, s + i:s + i + 1]
        jlogits, jcache = jlm.decode_step(params, jcfg, jcache, jnp.asarray(step))
        logits, cache = lm.decode_step(tp, tcfg, cache, torch.from_numpy(step))
        _close(logits, jlogits)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    assert cache["len"] == int(jcache["len"]) == s + steps


def test_decode_agrees_with_forward():
    """Prefill + decode logits equal the full forward's at each position
    (``tests/test_models_smoke.py::test_decode_consistent_with_forward``)."""
    _, _, tcfg, tp = _models("qwen2-1.5b", "pallas")
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, tcfg.vocab, (1, 8)))
    full, _ = lm.forward(tp, tcfg, tokens=toks)
    pre, cache = lm.prefill(tp, tcfg, tokens=toks[:, :7], cache_capacity=8)
    _close(pre, full[:, 6])
    dec, _ = lm.decode_step(tp, tcfg, cache, toks[:, 7:])
    _close(dec, full[:, 7])


def test_rotating_cache_write_matches_jax():
    """A decode step past the cache's capacity writes at len % cap and
    attends over the whole cache, as the JAX mask-and-where does."""
    jcfg, params, tcfg, tp = _models("qwen2-1.5b", "chunked")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (1, 8)).astype(np.int32)
    jlogits, jcache = jlm.prefill(params, jcfg, tokens=jnp.asarray(toks[:, :6]))
    logits, cache = lm.prefill(tp, tcfg, tokens=torch.from_numpy(toks[:, :6]))
    for i in (6, 7):  # the cache holds 6: these writes land at 0, then 1
        jlogits, jcache = jlm.decode_step(params, jcfg, jcache, jnp.asarray(toks[:, i:i + 1]))
        logits, cache = lm.decode_step(tp, tcfg, cache, torch.from_numpy(toks[:, i:i + 1]))
        _close(logits, jlogits)
    _close(cache["k"], jcache["k"])


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if get_reduced(a).family == "dense"])
def test_dense_forward_matches_jax(arch):
    """Every dense config: gelu MLPs (starcoder2, granite), MQA (granite),
    no QKV bias (glm4).  The MoE and VLM configs are held in
    ``tests/test_torch_moe.py`` and ``tests/test_torch_vlm.py``."""
    jcfg, params, tcfg, tp = _models(arch, "chunked", seed=2)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    want, _ = jlm.forward(params, jcfg, tokens=jnp.asarray(toks))
    _close(lm.forward(tp, tcfg, tokens=torch.from_numpy(toks))[0], want)


def test_gelu_is_the_tanh_approximation():
    x = np.random.default_rng(1).normal(0, 3, (4, 16)).astype(np.float32)
    w = {"w_up": np.eye(16, dtype=np.float32), "w_down": np.eye(16, dtype=np.float32)}
    want = jlayers.mlp_block({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), "gelu")
    got = layers.mlp_block({k: torch.from_numpy(v) for k, v in w.items()},
                           torch.from_numpy(x), "gelu")
    _close(got, want, 1e-6)


def test_rmsnorm_casts_back_before_the_weight():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 4, (8, 96)).astype(ml_dtypes.bfloat16)
    w = rng.normal(1, 0.3, (96,)).astype(ml_dtypes.bfloat16)
    want = np.asarray(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w)), np.float32)
    got = layers.rmsnorm(params_from_jax(x, "cpu"), params_from_jax(w, "cpu"))
    assert got.dtype == torch.bfloat16
    # one bf16 rounding apart at most (the two rsqrt may differ by an f32 ulp)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if get_reduced(a).family == "dense"])
def test_served_wave_gives_jax_greedy_tokens(arch):
    jcfg, params, tcfg, tp = _models(arch, "pallas", seed=7)
    batch, plen, gen, cap = 4, 8, 6, 16
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab, (3, plen))

    # the JAX launcher's wave: prefill, greedy token, then jitted serve steps
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


@pytest.mark.parametrize("arch", ["starcoder2-15b", "glm4-9b"])
def test_dense_init_draws_one_layer_at_a_time(arch, monkeypatch):
    """The stacked attention and MLP leaves are drawn one layer at a time
    (``stacked_init``): the largest f32 draw is one layer's leaf, never the
    whole stack, each layer is a draw of its own, and each layer's values
    have std 1/√fan_in with fan_in the per-layer shape's rows."""
    cfg = dataclasses.replace(get_reduced(arch), n_layers=3)
    sizes = []
    randn = torch.randn

    def counted(*shape, **kw):
        out = randn(*shape, **kw)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", counted)
    gen = torch.Generator("cpu").manual_seed(0)
    lead = (cfg.n_layers,)
    attn = layers.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                                 dtype=torch.float32, lead=lead)
    mlp = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype=torch.float32,
                          lead=lead)
    leaves = {**attn, **mlp}
    assert len(sizes) == len(leaves) * cfg.n_layers
    assert max(sizes) == max(t[0].numel() for t in leaves.values())
    for name, t in leaves.items():
        assert t.shape[0] == cfg.n_layers, name
        for i in range(cfg.n_layers):
            std = float(t[i].std())
            assert abs(std * np.sqrt(t.shape[-2]) - 1.0) < 0.05, (name, i, std)
        assert not torch.equal(t[0], t[1]), name


def test_serve_step_is_greedy():
    _, _, tcfg, tp = _models("qwen2-1.5b", "chunked")
    model = build_model(tcfg)
    _, cache = model.prefill(tp, {"tokens": torch.zeros((2, 4), dtype=torch.int32)}, 8)
    tok, logits, cache = make_serve_step(model)(tp, cache, torch.ones((2, 1), dtype=torch.int32))
    assert tok.dtype == torch.int32 and tok.shape == (2, 1)
    assert torch.equal(tok[:, 0], logits.argmax(-1).int()) and cache["len"] == 5


@pytest.mark.parametrize("family,item", [("encdec", "8.6")])
def test_other_families_are_not_ported(family, item):
    """No family waits for its slice any more: the last, enc-dec (ROADMAP
    Queue 1 item 8.6), builds with JAX's entry points (no ``init_state``:
    its prefill makes the decode cache).  Held to JAX in
    ``tests/test_torch_whisper.py``."""
    cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), family=family, n_enc_layers=1)
    model = build_model(cfg)
    assert None not in (model.prefill, model.decode) and model.init_state is None


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen2-vl-7b", "zamba2-7b", "rwkv6-1.6b"])
def test_moe_and_vlm_families_build(arch):
    """The MoE, VLM, hybrid and RWKV families build, with every entry
    point, and ``init_state`` gives the family's empty state."""
    cfg = get_reduced(arch)
    model = build_model(cfg)
    assert None not in (model.prefill, model.decode, model.init_state)
    state = model.init_state(2, 8)
    if cfg.family == "rwkv":
        (last, wkv), cm = state
        assert last.shape == cm.shape == (cfg.n_layers, 2, 1, cfg.d_model)
        assert wkv.shape == (cfg.n_layers, 2, cfg.d_model // 64, 64, 64)
        assert wkv.dtype == torch.float32
        return
    kv_points = cfg.n_attn_points if cfg.family == "hybrid" else cfg.n_layers
    assert state["len"] == 0 and state["k"].shape == (kv_points, 2, cfg.n_kv_heads, 8,
                                                      cfg.d_head)
    if cfg.family == "hybrid":
        assert state["conv"].shape == (cfg.n_layers, 2, 3, cfg.d_inner)
        assert state["ssm"].shape == (cfg.n_layers, 2, cfg.d_inner // 64, cfg.ssm_state, 64)


def test_layernorm_matches_jax():
    rng = np.random.default_rng(4)
    x, w, b = (rng.normal(m, 1, shape).astype(np.float32)
               for m, shape in ((2.0, (3, 5, 64)), (1.0, (64,)), (0.0, (64,))))
    want = jlayers.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = layers.layernorm(*(torch.from_numpy(a) for a in (x, w, b)))
    _close(got, want, 1e-5)


def test_rope_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 7, 32)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6), want, 1e-4)
