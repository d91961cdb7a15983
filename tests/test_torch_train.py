"""The port's training path against the JAX package's, on the CPU.

Reduced dense configs (Qwen2-1.5B's, with QKV biases, StarCoder2's, with
a GELU MLP, GLM4's, with no QKV bias, and Granite's, MQA over 3 layers)
in f32.  JAX initialises the parameters and makes the
batches; the QKV biases are then set to random values (JAX makes them
zero, which would leave their gradients untested), and
``params_from_jax`` carries parameters and AdamW state across.

Tolerances: the loss rtol 1e-5; gradients leaf by leaf rtol 2e-4, atol
1e-6·max|g| (f32 sums in another order); the optimizers on given
gradients within 1 ulp of JAX's (the same f32 arithmetic; AdamW's
parameters 2, through torch's CPU sqrt); token batches
bit for bit.  A train step's update p′ − p is held leaf by leaf as a norm,
‖Δ‖ ≤ 2e-3·‖u‖ + 1e-2·lr·√n: element by element an AdamW step sends
g/(|g| + eps), so a gradient element near eps = 1e-8, whose last digits
are f32 noise in either package, moves its update by up to lr (the
gradients' own atol, 1e-6·max|g|, is far above eps).
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
from repro.kernels import ops as jops  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.api import make_train_step as jax_train_step  # noqa: E402
from repro.train.optimizer import SGD as JaxSGD, AdamW as JaxAdamW  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.api import build_model, make_train_step, value_and_grad  # noqa: E402
from repro_torch.train.optimizer import SGD, AdamW, tree_leaves  # noqa: E402

ARCHS = ["qwen2-1.5b", "starcoder2-15b", "glm4-9b", "granite-34b"]
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
UPD_RTOL, UPD_ATOL = 2e-3, 1e-2
B, S = 4, 32


def _models(arch, seed=3, **over):
    """(JAX model, JAX params as numpy, port model, port params)."""
    jcfg = dataclasses.replace(jax_reduced(arch), **over)
    params = jax.device_get(jax_build(jcfg).init(jax.random.PRNGKey(seed)))
    attn = params["layers"]["attn"]
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = rng.normal(0, 0.5, attn[name].shape).astype(np.float32)
    tcfg = dataclasses.replace(get_reduced(arch), **over)
    return jax_build(jcfg), params, build_model(tcfg), params_from_jax(params, "cpu")


def _batch(cfg, step=0, b=B, s=S):
    """The JAX pipeline's batch, as numpy, with a few positions masked."""
    batch = JaxTokenPipeline(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=5).batch_at(step)
    batch["mask"][:, -3:] = 0.0
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _paths(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def _close_grads(got, want):
    """Leaf by leaf, in JAX's leaf order (``tree_leaves`` sorts as JAX)."""
    got = tree_leaves(got)
    want = _paths(want)
    assert len(got) == len(want)
    for g, (name, w) in zip(got, want):
        g = g.detach().float().numpy()
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL * np.abs(w).max(),
                                   err_msg=name)


def _close_updates(new, old, jnew, jold, lr):
    for g1, g0, (name, w1), (_, w0) in zip(tree_leaves(new), tree_leaves(old),
                                            _paths(jnew), _paths(jold)):
        got = g1.float().numpy().astype(np.float64) - g0.float().numpy()
        want = w1.astype(np.float64) - w0
        gap = np.linalg.norm(got - want)
        bound = UPD_RTOL * np.linalg.norm(want) + UPD_ATOL * lr * np.sqrt(want.size)
        assert gap <= bound, f"{name}: ‖Δ‖ {gap:.3g} > {bound:.3g}"


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_jax(arch):
    jm, params, tm, tp = _models(arch, loss_chunk=16)
    batch = _batch(tm.cfg)
    jloss, jgrads = jax.value_and_grad(jm.loss)(params, _jax(batch))
    tloss, tgrads = value_and_grad(tm.loss, tp, _torch(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    _close_grads(tgrads, jgrads)
    # the loss under no grad is the same function
    with torch.no_grad():
        np.testing.assert_allclose(float(tm.loss(tp, _torch(batch))), float(jloss),
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("chunk", [8, 32], ids=["chunk_below_s", "chunk_equal_s"])
def test_chunked_ce_loss_matches_jax(chunk):
    cfg = jax_reduced("qwen2-1.5b")
    rng = np.random.default_rng(chunk)
    x = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    emb = rng.normal(0, 0.05, (cfg.vocab, cfg.d_model)).astype(np.float32)
    batch = _batch(cfg)

    def jloss(x, emb):
        return jlm.chunked_ce_loss({"emb": emb}, cfg, x, jnp.asarray(batch["labels"]),
                                   jnp.asarray(batch["mask"]), chunk=chunk)

    want, (jgx, jge) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                                 jnp.asarray(emb))
    tx, temb = (torch.from_numpy(a).requires_grad_() for a in (x, emb))
    got = lm.chunked_ce_loss({"emb": temb}, get_reduced("qwen2-1.5b"), tx,
                             torch.from_numpy(batch["labels"]), torch.from_numpy(batch["mask"]),
                             chunk=chunk)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    _close_grads([tx.grad, temb.grad], [jgx, jge])


def test_chunked_ce_loss_refuses_a_ragged_chunk():
    cfg = get_reduced("qwen2-1.5b")
    x = torch.zeros(1, 12, cfg.d_model)
    with pytest.raises(ValueError, match="multiple of chunk"):
        lm.chunked_ce_loss({"emb": torch.zeros(cfg.vocab, cfg.d_model)}, cfg, x,
                           torch.zeros(1, 12, dtype=torch.int32), torch.ones(1, 12), chunk=8)


@pytest.mark.parametrize("causal,window,hq,hkv,s,block", [
    (True, None, 4, 4, 96, 32),
    (True, 20, 4, 2, 96, 32),
    (False, None, 6, 2, 80, 32),   # GQA, a shorter last block
    (True, 8, 6, 1, 64, 64),
], ids=["causal", "window_gqa", "noncausal_ragged", "window_mqa_one_block"])
def test_chunked_attention_gradient_matches_plain(causal, window, hq, hkv, s, block):
    rng = np.random.default_rng(s + hq)
    arrs = [rng.normal(0, 1, (2, h, s, 32)).astype(np.float32) for h in (hq, hkv, hkv)]
    dout = torch.from_numpy(rng.normal(0, 1, (2, hq, s, 32)).astype(np.float32))
    grads = []
    for fn in (lambda *a: ops.chunked_attention(*a, causal=causal, window=window,
                                                block_k=block),
               lambda *a: ref.flash_attention(*a, causal=causal, window=window)):
        qkv = [torch.from_numpy(a).requires_grad_() for a in arrs]
        out = fn(*qkv)
        out.backward(dout)
        grads.append([out.detach()] + [t.grad for t in qkv])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    if s % block == 0:
        # and against JAX's chunked attention under jax.grad
        def jfn(q, k, v):
            o = jops.chunked_attention(q, k, v, causal=causal, window=window, block_k=block)
            return jnp.sum(o * jnp.asarray(dout.numpy()))

        jg = jax.grad(jfn, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
        for got, want in zip(grads[0][1:], jg):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_chunked_attention_remat_keeps_no_block_logits():
    """With ``policy="remat"`` the forward saves no (…, S, block) logits for
    the backward: what autograd keeps is O(S·D)."""
    q, k, v = (torch.randn(1, 2, 128, 16, requires_grad=True) for _ in range(3))
    for policy, expect_logits in (("remat", False), ("none", True)):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
            out = ops.chunked_attention(q, k, v, block_k=32, policy=policy)
        assert any(sh[-2:] == (128, 32) and len(sh) == 5 for sh in saved) == expect_logits
        out.sum().backward()


def test_remat_and_remat_groups_give_the_same_loss_and_gradients():
    batch = _torch(_batch(get_reduced("qwen2-1.5b")))
    results = []
    for over in ({"remat": False}, {"remat": True}, {"remat": True, "remat_group": 2}):
        _, _, tm, tp = _models("qwen2-1.5b", n_layers=4, loss_chunk=16, **over)
        results.append(value_and_grad(tm.loss, tp, batch))
    (l0, g0), *rest = results
    for l, g in rest:
        torch.testing.assert_close(l, l0, rtol=1e-6, atol=0)
        for a, b in zip(tree_leaves(g), tree_leaves(g0)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_backbone_gives_each_stacked_leaf_one_gradient_buffer():
    """Trap 2: the layers are taken by one unbind per leaf, so autograd
    stacks each leaf's gradient once instead of adding a zero-filled copy
    of the whole leaf for every layer."""
    _, _, tm, tp = _models("qwen2-1.5b", n_layers=4, loss_chunk=16)
    live = {k: v for k, v in tp.items()}
    live["layers"] = {k: ({kk: vv.detach().requires_grad_() for kk, vv in v.items()}
                          if isinstance(v, dict) else v.detach().requires_grad_())
                      for k, v in tp["layers"].items()}
    loss = tm.loss(live, _torch(_batch(tm.cfg)))
    consumers = {}   # stacked leaf → the graph nodes that read it
    seen, stack = set(), [loss.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            if hasattr(nxt, "variable"):  # AccumulateGrad: a leaf
                consumers.setdefault(id(nxt.variable), []).append(type(fn).__name__)
            stack.append(nxt)
    stacked = tree_leaves(live["layers"])
    assert len(stacked) == 12
    for leaf in stacked:
        assert consumers[id(leaf)] == ["UnbindBackward0"]


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatch", [1, 2])
@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(steps, microbatch):
    lr = 3e-3
    jm, params, tm, tp = _models("qwen2-1.5b", loss_chunk=16)
    jstep, jopt = jax_train_step(jm, JaxAdamW(lr=lr), microbatch=microbatch)
    jstep = jax.jit(jstep)
    tstep, topt = make_train_step(tm, AdamW(lr=lr), microbatch=microbatch)
    jp, jo = params, jopt.init(params)
    tp_, to = tp, topt.init(tp)
    for step in range(steps):
        batch = _batch(tm.cfg, step)
        jp1, jo, jmet = jstep(jp, jo, _jax(batch))
        tp1, to, tmet = tstep(tp_, to, _torch(batch))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=LOSS_RTOL)
        _close_updates(tp1, tp_, jax.device_get(jp1), jax.device_get(jp), lr)
        jp, tp_ = jax.device_get(jp1), tp1
    assert int(to["step"]) == int(jo["step"]) == steps
    assert to["step"].dtype == torch.int32


def test_microbatched_gradients_accumulate_in_f32():
    """m > 1 sums the slices' gradients into f32 zeros and divides by m, as
    JAX does; a bf16 model's update then sees f32 gradients."""
    _, _, tm, tp = _models("qwen2-1.5b", loss_chunk=16)
    tp16 = {k: v for k, v in params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), _models("qwen2-1.5b")[1]), "cpu",
        dtype=torch.bfloat16).items()}
    model = build_model(dataclasses.replace(tm.cfg, dtype="bfloat16"))
    seen = []
    spy = AdamW()

    def update(grads, state, params):
        seen.extend(g.dtype for g in tree_leaves(grads))
        return spy.update(grads, state, params)

    from repro_torch.train.optimizer import Optimizer

    for m, dtype in ((1, torch.bfloat16), (2, torch.float32)):
        seen.clear()
        step, opt = make_train_step(model, Optimizer(spy.init, update), microbatch=m)
        new, _, met = step(tp16, opt.init(tp16), _torch(_batch(model.cfg)))
        assert set(seen) == {dtype} and np.isfinite(float(met["loss"]))
        assert all(a.dtype == torch.bfloat16 for a in tree_leaves(new))


def test_grad_constraint_places_the_accumulator():
    """``grad_constraint`` (ZeRO-2's hook; tests/test_torch_pjit_mesh.py runs
    it on DTensors) is applied to the f32 zeros and to each microbatch's
    gradients; an identity constraint leaves the step's bits as they were."""
    _, params, tm, tp = _models("qwen2-1.5b")
    batch = _torch(_batch(tm.cfg))
    seen = []

    def constrain(tree):
        seen.append([t.dtype for t in tree_leaves(tree)])
        return tree

    got = make_train_step(tm, SGD(), microbatch=2, grad_constraint=constrain)[0](
        tp, SGD().init(tp), batch)
    want = make_train_step(tm, SGD(), microbatch=2)[0](tp, SGD().init(tp), batch)
    assert len(seen) == 3  # the accumulator, then two microbatches' gradients
    assert all(d == torch.float32 for d in seen[0])
    assert torch.equal(got[2]["loss"], want[2]["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got[0]), tree_leaves(want[0])))


# ---------------------------------------------------------------------------
# the optimizers on given gradients
# ---------------------------------------------------------------------------


def _tree(rng, dtype, scale):
    return {"a": (rng.normal(0, scale, (5, 7))).astype(dtype),
            "b": {"c": (rng.normal(0, scale, (3,))).astype(dtype),
                  "d": (rng.normal(0, scale, (2, 2, 3))).astype(dtype)}}


def _grads(rng, dtype, step):
    """Gradients k·step, |k| < 64: their squares add exactly in f32 in any
    order, so the clip's norm is JAX's to the bit (XLA and torch sum in
    different orders); k·step is exact in bf16 too."""
    return {"a": (rng.integers(-63, 64, (5, 7)) * step).astype(dtype),
            "b": {"c": (rng.integers(-63, 64, (3,)) * step).astype(dtype),
                  "d": (rng.integers(-63, 64, (2, 2, 3)) * step).astype(dtype)}}


def _ulps(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    ints = {2: np.int16, 4: np.int32}[got.dtype.itemsize]
    return np.abs(got.view(ints).astype(np.int64) - want.view(ints).astype(np.int64)).max()


@pytest.mark.parametrize("pdtype,gdtype,scale", [
    (np.float32, np.float32, 2.0 ** -12),
    (np.float32, np.float32, 2.0 ** -4),                 # clipping active
    (np.float32, ml_dtypes.bfloat16, 2.0 ** -4),         # the promotion trap
    (ml_dtypes.bfloat16, ml_dtypes.bfloat16, 2.0 ** -4),
], ids=["f32", "f32_clipped", "bf16_grads_clipped", "bf16_params_clipped"])
@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_matches_jax_within_an_ulp(name, pdtype, gdtype, scale):
    rng = np.random.default_rng(7)
    params = _tree(rng, pdtype, 1.0)
    jopt, topt = ((JaxAdamW(lr=1e-2), AdamW(lr=1e-2)) if name == "adamw"
                  else (JaxSGD(lr=1e-2), SGD(lr=1e-2)))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_jax(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        grads = _grads(rng, gdtype, scale)
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        tp, ts = topt.update(params_from_jax(grads, "cpu"), ts, tp)
    gnorm = np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                        for g in jax.tree_util.tree_leaves(grads)))
    assert (gnorm > 1.0) == (scale > 2.0 ** -12)  # the clip is active where meant
    # AdamW's parameters go through one sqrt, which torch's vectorised CPU
    # kernel rounds off by one ulp on some inputs (XLA's and CUDA's sqrt are
    # correctly rounded): 2 ulps there, 1 ulp everywhere else
    p_ulps = 2 if name == "adamw" else 1
    for got, (pname, want) in zip(tree_leaves(tp), _paths(jp)):
        got = got.view(torch.int16).numpy().view(ml_dtypes.bfloat16) \
            if got.dtype == torch.bfloat16 else got.numpy()
        assert _ulps(got, want) <= p_ulps, pname
    for key in [k for k in ts if k != "step"]:
        for got, (pname, want) in zip(tree_leaves(ts[key]), _paths(js[key])):
            assert got.dtype == torch.float32 and _ulps(got.numpy(), want) <= 1, key + pname
    assert int(ts["step"]) == int(js["step"]) == 3 and ts["step"].dtype == torch.int32


def test_adamw_clip_scale_is_jaxs_to_the_bit():
    """The clip's norm is the correctly rounded sqrt of the f32 sum of
    squares, as XLA takes it (ROADMAP Queue 3 item 31): at the last step of
    the clipped f32 case above (the sum of squares has f32 bits 1133081728;
    torch's f32 sqrt gave 1099211952 on an AMD EPYC with AVX-512, the
    correctly rounded sqrt is 1099211953) the sum is exact in both
    packages, and the port's clip scale equals JAX's bit for bit on every
    host, whatever torch's own f32 sqrt gives on this CPU."""
    from repro_torch.train.optimizer import clip_scale

    rng = np.random.default_rng(7)
    _tree(rng, np.float32, 1.0)
    for _ in range(3):
        grads = _grads(rng, np.float32, 2.0 ** -4)
    leaves = jax.tree_util.tree_leaves(grads)
    ss = sum(jnp.sum(jnp.square(jnp.asarray(g, jnp.float32))) for g in leaves)
    want = jnp.minimum(1.0, 1.0 / (jnp.sqrt(ss) + 1e-9))        # repro/train/optimizer.py:35-36
    got = clip_scale(tree_leaves(params_from_jax(grads, "cpu")), 1.0)
    assert np.asarray(ss).view(np.int32) == 1133081728
    assert got.dtype == torch.float32 and float(want) < 1.0
    assert np.asarray(got).view(np.int32) == np.asarray(want, np.float32).view(np.int32)


def test_torch_cpu_sqrt_is_not_correctly_rounded():
    """Why AdamW's parameters get 2 ulps above: on the CPU, torch's f32 sqrt
    misses the correctly rounded result (numpy's, and the f64 sqrt rounded
    to f32) by one ulp on some inputs, and never by more."""
    x = np.random.default_rng(0).uniform(0, 10, 1 << 16).astype(np.float32)
    got = torch.sqrt(torch.from_numpy(x)).numpy()
    exact = np.sqrt(x.astype(np.float64)).astype(np.float32)
    assert np.array_equal(np.sqrt(x), exact)
    assert _ulps(got, exact) <= 1


def test_params_from_jax_carries_adamw_state():
    """JAX's AdamW state {"m", "v", "step"} crosses as it is and the port's
    next update continues JAX's."""
    rng = np.random.default_rng(8)
    params = _tree(rng, np.float32, 1.0)
    jopt = JaxAdamW(lr=1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    for _ in range(2):
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, _grads(rng, np.float32, 0.0625)),
                             js, jp)
    ts = params_from_jax(jax.device_get(js), "cpu")
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == () and int(ts["step"]) == 2
    grads = _grads(rng, np.float32, 0.0625)
    jp2, js2 = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
    tp2, ts2 = AdamW(lr=1e-2).update(params_from_jax(grads, "cpu"), ts,
                                     params_from_jax(jax.device_get(jp), "cpu"))
    for got, (_, want) in zip(tree_leaves(ts2["m"]) + tree_leaves(ts2["v"]),
                              _paths(js2["m"]) + _paths(js2["v"])):
        assert _ulps(got.numpy(), want) <= 1
    for got, (_, want) in zip(tree_leaves(tp2), _paths(jp2)):
        assert _ulps(got.numpy(), want) <= 2  # one sqrt: see above


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 1)])
def test_token_pipeline_is_bit_equal(n_hosts, host_id):
    kw = dict(vocab=997, seq_len=33, global_batch=6, seed=11, n_hosts=n_hosts, host_id=host_id)
    mine, theirs = TokenPipeline(**kw), JaxTokenPipeline(**kw)
    for step in (0, 1, 17):
        a, b = mine.batch_at(step), theirs.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    it, jt = mine.prefetching(start_step=5, depth=2), theirs.prefetching(start_step=5, depth=2)
    try:
        for _ in range(3):
            (s1, a), (s2, b) = next(it), next(jt)
            assert s1 == s2 and all(np.array_equal(a[k], b[k]) for k in a)
    finally:
        it.close()
        jt.close()


# ---------------------------------------------------------------------------
# the kernel refuses a gradient; the launcher
# ---------------------------------------------------------------------------


def test_pallas_attention_refuses_grad_mode():
    """The kernel is forward-only, as JAX's is (``jax.grad`` through it
    raises): under grad mode with q, k or v requiring grad the port raises,
    on the CPU too, rather than drop their gradients on the card."""
    q, k, v = (torch.randn(1, 2, 16, 32) for _ in range(3))
    with pytest.raises(ValueError, match="forward-only.*chunked"):
        ops.attention(q.requires_grad_(), k, v, mode="pallas")
    with pytest.raises(ValueError, match="forward-only"):
        ops.flash_attention(q, k, v)
    with torch.no_grad():
        ops.attention(q, k, v, mode="pallas")
    with torch.inference_mode():
        ops.attention(q, k, v, mode="pallas")
    ops.attention(q.detach(), k, v, mode="pallas")  # nothing asks for a gradient


def test_jax_pallas_attention_has_no_gradient():
    """The reference behaviour the refusal mirrors."""
    q = jnp.ones((1, 2, 16, 32), jnp.float32)
    with pytest.raises(Exception):
        jax.grad(lambda q: jnp.sum(jops.attention(q, q, q, mode="pallas", interpret=True)))(q)


def test_batch_fn_refuses_the_families_not_ported():
    """No family's batch is refused any more: the encdec batch (tokens and
    stub frames, ROADMAP Queue 1 item 8.6) and the vlm batch are built
    (held to JAX's in ``tests/test_torch_whisper.py`` and
    ``tests/test_torch_vlm.py``)."""
    cfg = get_reduced("qwen2-1.5b")
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=8, global_batch=2)
    enc = train_mod.make_batch_fn(dataclasses.replace(cfg, family="encdec"), pipe, "cpu")(3)
    assert sorted(enc) == ["frames", "labels", "mask", "tokens"]
    assert enc["frames"].shape == (2, 8, cfg.d_model) and enc["frames"].dtype == torch.float32
    vlm = train_mod.make_batch_fn(dataclasses.replace(cfg, family="vlm"), pipe, "cpu")(3)
    assert sorted(vlm) == ["embeds", "labels", "mask", "positions3"]
    assert vlm["embeds"].shape == (2, 8, cfg.d_model) and vlm["positions3"].shape == (3, 2, 8)
    batch = train_mod.make_batch_fn(cfg, pipe, "cpu")(3)
    want = pipe.batch_at(3)
    assert all(np.array_equal(batch[k].numpy(), want[k]) for k in want)


def test_train_driver_end_to_end(tmp_path):
    """Reduced-config training through the full driver on the CPU: loss
    drops, checkpoint written, resume works (tests/test_substrate.py)."""
    common = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
              "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path)]
    losses = train_mod.main(common + ["--steps", "12", "--ckpt-every", "6"])
    assert losses[-1] < losses[0]
    losses2 = train_mod.main(common + ["--steps", "4", "--ckpt-every", "100", "--resume"])
    assert losses2[0] < losses[0]  # continued from trained weights


def test_train_driver_resume_continues_the_uninterrupted_run(tmp_path):
    """Three steps, a checkpoint, three resumed steps: the resumed losses are
    the uninterrupted run's, and the restored state is the saved state."""
    common = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
              "--batch", "4", "--seq", "32"]
    whole = train_mod.main(common + ["--steps", "6", "--ckpt-every", "100",
                                     "--ckpt-dir", str(tmp_path / "a")])
    state3, first = train_mod.run(train_mod.parse_args(
        common + ["--steps", "3", "--ckpt-every", "3", "--ckpt-dir", str(tmp_path / "b")]))
    from repro_torch.distributed import CheckpointManager

    restored, extra = CheckpointManager(tmp_path / "b").restore(state3)
    assert extra == {"step": 3}
    for a, b in zip(tree_leaves(restored), tree_leaves(state3)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    rest = train_mod.main(common + ["--steps", "3", "--ckpt-every", "100", "--resume",
                                    "--ckpt-dir", str(tmp_path / "b")])
    np.testing.assert_allclose(first + rest, whole, rtol=1e-6)


def test_train_driver_without_a_card_exits():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    with pytest.raises(SystemExit, match="no.*visible|none is visible"):
        train_mod.main(["--reduced", "--steps", "1"])
