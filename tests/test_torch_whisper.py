"""The port's enc-dec family (Whisper-style: a stub-frame encoder, a causal
decoder with cross-attention) against the JAX package's, on the CPU; and
``chunked_attention`` where the query and key lengths differ, which is the
decoder's cross-attention.

Weights are drawn by JAX from a seed and carried by ``params_from_jax``;
frames and tokens are numpy-seeded.  The reduced config has 2 + 2 layers,
d_model 128, 4 heads of 32, f32.  The encoder runs 24 frames and the
decoder 16 tokens unless a test says otherwise, so the cross-attention
takes JAX's blocks (S_q ≠ S_k).

Tolerances: ``chunked_attention`` at S_q ≠ S_k rtol 1e-5 (atol 1e-6) in
f32; ``encode`` rtol 2e-5 (atol 2e-5) in f32 and, in bf16, within 2⁻⁵ of
the largest |value| (bf16 rounds every product and the residual stream:
two packages' roundings of one sum land an ulp apart, 2⁻⁸ relative, and
grow through the layers); decoder states, the loss, the prefill cache and
the decode steps' logits rtol 2e-5 (atol 2e-5); gradients by
‖Δ‖ ≤ 1e-4·‖g‖ per leaf; served tokens and train-batch frames exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.api import make_serve_step as jax_serve_step  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.serve import Request, make_run_wave  # noqa: E402
from repro_torch.models import whisper  # noqa: E402
from repro_torch.models.api import build_model, value_and_grad  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

ARCH = "whisper-base"
TOL = 2e-5
ATTN_RTOL, ATTN_ATOL = 1e-5, 1e-6
BF16_SHARE = 2.0 ** -5
GRAD_REL = 1e-4
S_ENC, S_DEC = 24, 16


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _models(mode="chunked", seed=4, **over):
    jcfg = dataclasses.replace(jax_reduced(ARCH), attn_mode=mode, **over)
    params = jax.device_get(jax_build(jcfg).init(jax.random.PRNGKey(seed)))
    tcfg = dataclasses.replace(get_reduced(ARCH), attn_mode=mode, **over)
    return jcfg, params, tcfg, params_from_jax(params, "cpu")


def _frames(b=2, s=S_ENC, d=128, seed=3):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)


def _tokens(vocab, b=2, s=S_DEC, seed=5):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# chunked_attention at S_q != S_k (ROADMAP Queue 3 item 30)
# ---------------------------------------------------------------------------


def _qkv(sq, sk, d=8, h=2, seed=0):
    rng = np.random.default_rng(seed + sq + sk)
    return (rng.normal(size=(2, h, sq, d)).astype(np.float32),
            rng.normal(size=(2, h, sk, d)).astype(np.float32),
            rng.normal(size=(2, h, sk, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(1, 8), (1, 1500), (4, 8), (512, 1500), (1024, 1500),
                                   (1024, 600)])
def test_chunked_attention_over_other_key_lengths_matches_jax(sq, sk, causal):
    """JAX's blocks come from the query length: S_q // bk blocks of
    bk = min(512, S_q) keys, each cut by ``dynamic_slice`` (which clamps
    its start: (1024, 600) takes keys 88..599 as positions 512..1023), so
    only the first S_q keys (or the clamped ones) are seen."""
    q, k, v = _qkv(sq, sk)
    want = jops.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    got = ops.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATTN_RTOL, atol=ATTN_ATOL)


def test_chunked_attention_decode_step_sees_key_zero_alone():
    """The smallest input of item 30: one query over 8 keys attends to key
    0 only, so the output is v[..., 0, :] (the full softmax differs)."""
    q, k, v = _qkv(1, 8)
    got = ops.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=False)
    np.testing.assert_array_equal(got.numpy()[:, :, 0], v[:, :, 0])
    full = ops.chunked_attention(*(torch.from_numpy(a) for a in (q, k[:, :, :1].repeat(8, 2),
                                                                 v[:, :, :1].repeat(8, 2))),
                                 causal=False)
    np.testing.assert_array_equal(got.numpy(), full.numpy())


@pytest.mark.parametrize("sq,sk", [(8, 4), (600, 1500)])
def test_chunked_attention_raises_where_jax_fails(sq, sk):
    """A block wider than the keys (bk = min(512, S_q) > S_k) or a query
    length that is not a multiple of the block: JAX fails, the port raises."""
    q, k, v = _qkv(sq, sk)
    with pytest.raises((TypeError, AssertionError)):
        jops.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=False)
    with pytest.raises(ValueError, match="JAX's cannot cut"):
        ops.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=False)


def test_chunked_attention_at_equal_lengths_is_unchanged():
    """S_q == S_k keeps the port's blocks (the last may be shorter), so a
    length JAX refuses (600, not a multiple of 512) still runs, as every
    self-attention caller had it (ROADMAP Queue 3 item 32)."""
    q, k, v = _qkv(600, 600)
    with pytest.raises(AssertionError):
        jops.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.chunked_attention(tq, tk, tv, causal=True)
    want = ops.attention(tq, tk, tv, causal=True, mode="ref")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# configs, init, n_params
# ---------------------------------------------------------------------------


def test_whisper_configs_are_jaxs():
    for name, get, jget in (("CONFIG", get_config, jax_config),
                            ("REDUCED", get_reduced, jax_reduced)):
        got, want = dataclasses.asdict(get(ARCH)), dataclasses.asdict(jget(ARCH))
        assert got == want, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_init_makes_jaxs_tree(dtype):
    """Leaf for leaf (shapes and dtypes): stacked enc_layers / dec_layers,
    the cross block with as many kv heads as query heads."""
    jcfg = dataclasses.replace(jax_reduced(ARCH), dtype=dtype, n_kv_heads=2)
    want = jax.eval_shape(lambda k: jax_build(jcfg).init(k), jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_reduced(ARCH), dtype=dtype, n_kv_heads=2)
    got = whisper.init_encdec(tcfg, torch.Generator("cpu").manual_seed(0))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype)
    assert got["dec_layers"]["cross"]["wk"].shape == (2, 128, 4 * 32)


def _n_weights(tree):
    """Elements of every leaf but the norms (``n_params`` counts none)."""
    return sum(int(np.prod(leaf.shape)) for path, leaf in
               jax.tree_util.tree_leaves_with_path(tree)
               if "norm" not in jax.tree_util.keystr(path))


def test_n_params_counts_the_tree():
    """``ModelConfig.n_params`` against the initialised tree: the reduced
    config's, and Whisper-base's at full width (70,595,072 weights and
    16,384 norm elements; JAX's tree by shape)."""
    cfg = get_reduced(ARCH)
    assert cfg.n_params() == _n_weights(build_model(cfg).init(
        torch.Generator("cpu").manual_seed(0)))
    full = get_config(ARCH)
    want = jax.eval_shape(lambda k: jax_build(jax_config(ARCH)).init(k), jax.random.PRNGKey(0))
    assert full.n_params() == _n_weights(want) == 70_595_072
    assert sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(want)) == 70_611_456


# ---------------------------------------------------------------------------
# encode, decode_train, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [16, 512])
@pytest.mark.parametrize("mode", ["chunked", "ref", "pallas"])
def test_encode_matches_jax(mode, s):
    """The non-causal encoder at the config's attention mode: "pallas" is
    JAX's flash_attention_p in interpret mode against the port's
    flash_attention (its plain version on the CPU)."""
    jcfg, params, tcfg, tp = _models(mode)
    frames = _frames(s=s)
    want = jwhisper.encode(params, jcfg, jnp.asarray(frames))
    with torch.no_grad():
        got = whisper.encode(tp, tcfg, torch.from_numpy(frames))
    assert got.shape == (2, s, 128) and got.dtype == torch.float32
    _close(got, want)


def test_encode_bf16_matches_jax():
    jcfg, params, tcfg, _ = _models(dtype="bfloat16")
    tp = params_from_jax(params, "cpu")
    frames = _frames()
    want = np.asarray(jwhisper.encode(params, jcfg, jnp.asarray(frames)), np.float32)
    with torch.no_grad():
        got = whisper.encode(tp, tcfg, torch.from_numpy(frames))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= BF16_SHARE * np.abs(want).max()


def test_decode_train_matches_jax():
    """Teacher-forced decoder states over 16 tokens against 24 encoder
    frames (the cross-attention's JAX blocks)."""
    jcfg, params, tcfg, tp = _models()
    frames, toks = _frames(), _tokens(jcfg.vocab)
    enc = jwhisper.encode(params, jcfg, jnp.asarray(frames))
    want = jwhisper.decode_train(params, jcfg, enc, jnp.asarray(toks))
    with torch.no_grad():
        tenc = whisper.encode(tp, tcfg, torch.from_numpy(frames))
        got = whisper.decode_train(tp, tcfg, tenc, torch.from_numpy(toks))
    assert got.shape == (2, S_DEC, 128)
    _close(got, want)


def _batch(vocab, seq=S_DEC, seed=6):
    batch = JaxTokenPipeline(vocab=vocab, seq_len=seq, global_batch=2, seed=seed).batch_at(0)
    batch["mask"][:, -3:] = 0.0
    batch["frames"] = _frames(s=S_ENC)
    return batch


@pytest.mark.parametrize("remat", [False, True])
def test_encdec_loss_and_gradients_match_jax(remat):
    """``encdec_loss`` (the chunked CE over 2 chunks) and its gradients by
    ``torch.autograd.grad`` against ``jax.grad``; remat on checkpoints each
    encoder and decoder layer."""
    jcfg, params, tcfg, tp = _models(remat=remat, loss_chunk=8)
    batch = _batch(jcfg.vocab)
    jloss, jgrads = jax.value_and_grad(jax_build(jcfg).loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = value_and_grad(build_model(tcfg).loss, tp,
                                   {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    got = tree_leaves(tgrads)
    assert len(got) == len(want) == len(tree_leaves(tp))
    for g, (path, w) in zip(got, want):
        g, w = g.double().numpy(), np.asarray(w, np.float64)
        assert np.linalg.norm(g - w) <= GRAD_REL * np.linalg.norm(w) + 1e-12, \
            jax.tree_util.keystr(path)


def test_remat_gives_the_same_loss_and_gradients():
    _, _, tcfg, tp = _models(loss_chunk=8)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in _batch(tcfg.vocab).items()}
    (l0, g0), (l1, g1) = (value_and_grad(build_model(dataclasses.replace(tcfg, remat=r)).loss,
                                         tp, batch) for r in (False, True))
    assert float(l0) == float(l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# serving: prefill, decode, the serve wave
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["chunked", "pallas"])
def test_prefill_cache_and_decode_steps_match_jax(mode):
    """Prefill's cache tree (the empty self cache, every layer's cross K/V,
    len 0; shapes, dtypes, values), then 8 greedy decode steps' logits and
    the self cache they wrote."""
    jcfg, params, tcfg, tp = _models(mode)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    frames, cap = _frames(), 12
    jst = jm.prefill(params, {"frames": jnp.asarray(frames)}, cap)
    with torch.inference_mode():
        tst = tm.prefill(tp, {"frames": torch.from_numpy(frames)}, cap)
    assert sorted(tst) == sorted(jst) == ["cross_k", "cross_v", "k", "len", "v"]
    assert tst["len"] == int(jst["len"]) == 0
    assert tst["cross_k"].shape == (tcfg.n_layers, 2, tcfg.n_heads, S_ENC, tcfg.d_head)
    assert tst["k"].shape == (tcfg.n_layers, 2, tcfg.n_kv_heads, cap, tcfg.d_head)
    for key in ("k", "v", "cross_k", "cross_v"):
        assert tuple(tst[key].shape) == jst[key].shape, key
        assert str(tst[key].dtype)[6:] == str(jst[key].dtype), key
        _close(tst[key], jst[key])
    tok = np.zeros((2, 1), np.int32)
    for _ in range(8):
        jl, jst = jm.decode(params, jst, jnp.asarray(tok))
        with torch.inference_mode():
            tl, tst = tm.decode(tp, tst, torch.from_numpy(tok))
        assert tl.shape == (2, tcfg.vocab) and tl.dtype == torch.float32
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    assert tst["len"] == int(jst["len"]) == 8
    for key in ("k", "v"):
        _close(tst[key], jst[key])


def test_prefill_launches_the_kernel_once_per_encoder_layer():
    """attn_mode "pallas" sends the encoder's self-attention through
    ``ops.flash_attention`` once per encoder layer, non-causal; the
    decoder's self- and cross-attention never reach it."""
    _, _, tcfg, tp = _models("pallas")
    calls = []
    original = ops.flash_attention

    def counted(*a, **kw):
        calls.append((a[0].shape, kw["causal"]))
        return original(*a, **kw)

    ops.flash_attention = counted
    try:
        model = build_model(tcfg)
        with torch.inference_mode():
            st = model.prefill(tp, {"frames": torch.from_numpy(_frames())}, 8)
            assert len(calls) == tcfg.n_enc_layers
            model.decode(tp, st, torch.zeros((2, 1), dtype=torch.int32))
    finally:
        ops.flash_attention = original
    assert calls == [((2, tcfg.n_heads, S_ENC, tcfg.d_head), False)] * tcfg.n_enc_layers


def test_decode_step_sees_encoder_frame_zero_alone():
    """ROADMAP Queue 3 item 30 at model level, in both packages: a decode
    step's logits do not change when the cross K/V of encoder positions
    1… change (its cross-attention's one block holds position 0 only)."""
    jcfg, params, tcfg, tp = _models()
    jm, tm = jax_build(jcfg), build_model(tcfg)
    frames, tok = _frames(), np.ones((2, 1), np.int32)
    with torch.inference_mode():
        st = tm.prefill(tp, {"frames": torch.from_numpy(frames)}, 4)
        moved = dict(st, k=st["k"].clone(), v=st["v"].clone(),
                     cross_k=st["cross_k"].clone(), cross_v=st["cross_v"].clone())
        moved["cross_k"][:, :, :, 1:] += 1.0
        moved["cross_v"][:, :, :, 1:] *= -3.0
        got, _ = tm.decode(tp, st, torch.from_numpy(tok))
        got_moved, _ = tm.decode(tp, moved, torch.from_numpy(tok))
    assert torch.equal(got, got_moved)
    jst = jm.prefill(params, {"frames": jnp.asarray(frames)}, 4)
    jmoved = dict(jst, cross_k=jst["cross_k"].at[:, :, :, 1:].add(1.0),
                  cross_v=jst["cross_v"].at[:, :, :, 1:].multiply(-3.0))
    want, _ = jm.decode(params, jst, jnp.asarray(tok))
    want_moved, _ = jm.decode(params, jmoved, jnp.asarray(tok))
    np.testing.assert_array_equal(np.asarray(want), np.asarray(want_moved))
    _close(got, want)


def test_serve_wave_matches_jaxs_run_wave():
    """``make_run_wave``'s encdec branch against JAX's launcher built the
    same way: the prompts, then per wave frames (batch, prompt_len, d_model)
    drawn from the same generator after them, ``prefill``, a zero token and
    greedy steps.  Two waves (the second draws the next frames); the
    prompts are not read (Queue 3 item 25)."""
    jcfg, params, tcfg, tp = _models("pallas", seed=7)
    batch, plen, gen, cap, n = 2, 16, 5, 8, 4
    jmodel = jax_build(jcfg)
    serve = jax.jit(jax_serve_step(jmodel))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, jcfg.vocab, (n, plen))
    want = []
    for _ in range(n // batch):
        frames = jnp.asarray(rng.normal(size=(batch, plen, jcfg.d_model)), jnp.float32)
        state = jmodel.prefill(params, {"frames": frames}, cap)
        tok = jnp.zeros((batch, 1), jnp.int32)
        out = np.zeros((batch, gen), np.int32)
        for i in range(gen):
            tok, _, state = serve(params, state, tok)
            out[:, i] = np.asarray(tok[:, 0])
        want.append(out)
    trng = np.random.default_rng(0)
    tprompts = trng.integers(0, tcfg.vocab, (n, plen))
    run_wave = make_run_wave(build_model(tcfg), tp, batch=batch, prompt_len=plen, gen=gen,
                             cache_cap=cap, device="cpu", frames_rng=trng)
    for w in range(n // batch):
        got = run_wave([Request(rid=w * batch + j, prompt=tprompts[w * batch + j])
                        for j in range(batch)])
        assert sorted(got) == [w * batch + j for j in range(batch)]
        for j in range(batch):
            np.testing.assert_array_equal(got[w * batch + j], want[w][j])
    assert not np.array_equal(want[0], want[1])


def test_serve_wave_needs_its_frames_generator():
    _, _, tcfg, tp = _models()
    with pytest.raises(ValueError, match="frames_rng"):
        make_run_wave(build_model(tcfg), tp, batch=2, prompt_len=4, gen=2, cache_cap=4,
                      device="cpu")


def test_whisper_serve_cli_on_the_cpu():
    outputs = serve_mod.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
                              "--batch", "2", "--gen", "3", "--prompt-len", "8",
                              "--attn-mode", "pallas"])
    assert sorted(outputs) == [0, 1, 2] and all(t.shape == (3,) for t in outputs.values())


# ---------------------------------------------------------------------------
# training: the batch and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 3])
def test_batch_fn_frames_are_jaxs(step):
    """The encdec batch: the pipeline's tokens, labels and mask and stub
    frames from ``np.random.default_rng((4321, step))``, bit-equal to JAX's."""
    cfg = get_reduced(ARCH)
    want = jax_train.make_batch_fn(jax_reduced(ARCH), JaxTokenPipeline(
        vocab=cfg.vocab, seq_len=16, global_batch=2))(step)
    got = train_mod.make_batch_fn(cfg, TokenPipeline(vocab=cfg.vocab, seq_len=16,
                                                     global_batch=2), "cpu")(step)
    assert sorted(got) == sorted(want) == ["frames", "labels", "mask", "tokens"]
    assert got["frames"].dtype == torch.float32 and got["frames"].shape == (2, 16, cfg.d_model)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_whisper_trains_two_steps_from_the_launcher(tmp_path):
    """The launcher's encdec batches run ``encdec_loss``: 2 AdamW steps on
    the reduced config, finite losses; ``--layers`` cuts both stacks."""
    args = train_mod.parse_args(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                                 "--batch", "2", "--seq", "16", "--layers", "1",
                                 "--ckpt-dir", str(tmp_path)])
    (params, _), losses = train_mod.run(args)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert params["enc_layers"]["attn"]["wq"].shape[0] == 1
    assert params["dec_layers"]["mlp_norm"].shape[0] == 1
