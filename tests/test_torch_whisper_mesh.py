"""The enc-dec family over a mesh of ranks: the reduced Whisper (2 + 2
layers, 4 heads of 32, vocab 512) sharded over a 2 × 2 (``data`` ×
``model``) mesh of four gloo ranks on the CPU, against the JAX package's
one-device steps; and the embedding lookups of RWKV and Whisper over a
vocab-split table (ROADMAP Queue 3 item 48).

Four rank processes (``launch.hermetic.run_ranks``) lower the same plan
with ``lower_to_pjit`` (microbatch 2), place the full weights and call the
step on frames, tokens, labels and mask (made as
``tests/test_torch_whisper.py`` makes them): once with an optimizer that
hands the gradients back, once with AdamW.  Rank 0 also runs the port's
one-device step.  Then each rank prefills over the mesh
(``make_prefill_step`` on the weights placed by the sharding table, the
frames by ``batch_specs``) and runs 4 decode steps (``make_serve_step``)
fed JAX's greedy tokens from a zero token; a decode step's
cross-attention sees encoder frame 0 alone, as JAX's (Queue 3 item 30).
A model rank holds 2 of the 4 heads and half the vocabulary.

Tolerances: ``tests/test_torch_whisper.py``'s (the loss, the prefill cache
and the decode steps' logits rtol/atol 2e-5; gradients ‖Δ‖ ≤ 1e-4·‖g‖ per
leaf); an AdamW step's update by ‖Δ‖ ≤ 2e-3·‖u‖ + 1e-2·lr·√n
(``tests/test_torch_pjit_mesh.py``'s); against the port's one-device step
the loss rtol 2e-5 and each gradient leaf ‖Δ‖/‖g‖ ≤ 1e-5.
"""

import dataclasses
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.api import make_train_step as jax_train_step  # noqa: E402
from repro.train.optimizer import AdamW as JaxAdamW  # noqa: E402
from repro.train.optimizer import Optimizer as JaxOptimizer  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.hermetic import run_ranks  # noqa: E402
from repro_torch.models import lm, ssm, whisper  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

from test_torch_spmd import ROOT  # noqa: E402

ARCH = "whisper-base"
B, S_ENC, S_DEC, MICRO, LR = 4, 24, 16, 2, 3e-3
TOL = 2e-5
GRAD_REL = 1e-4
UPD_RTOL, UPD_ATOL = 2e-3, 1e-2
SHARD_REL = 1e-5
CAP, STEPS = 12, 4
WORLD, TIMEOUT_S = 4, 300
CACHE = ("k", "v", "cross_k", "cross_v")

#: counts the lookups that go through ``sharding.vocab_parallel_embedding``
#: and any index of a DTensor table of ``vocab`` rows (the lookup item 48
#: repaired), over the rank's whole run
LOOKUPS = '''
from torch.distributed.tensor import DTensor
from torch.overrides import TorchFunctionMode
from repro_torch.models import lm as lm_mod

lookups = {"vocab_parallel": [], "table_index": 0}
_vpe = lm_mod.vocab_parallel_embedding


def counted(emb, tokens):
    lookups["vocab_parallel"].append(tuple(tokens.shape))
    return _vpe(emb, tokens)


lm_mod.vocab_parallel_embedding = counted


class TableIndex(TorchFunctionMode):
    def __init__(self, vocab):
        super().__init__()
        self.vocab = vocab

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (func is torch.Tensor.__getitem__ and isinstance(args[0], DTensor)
                and args[0].ndim == 2 and args[0].shape[0] == self.vocab):
            lookups["table_index"] += 1
        return func(*args, **(kwargs or {}))
'''

RANK_SCRIPT = '''
import datetime, os, pickle
import torch, torch.distributed as dist

dist.init_process_group("gloo", init_method="file://" + os.environ["INIT_FILE"],
                        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.frontends.tensor import lower_to_pjit, plan_train_program
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import sharding as shd
from repro_torch.models.api import (build_model, make_prefill_step, make_serve_step,
                                    make_train_step)
from repro_torch.train.optimizer import AdamW, Optimizer, tree_map
''' + LOOKUPS + '''
work = os.environ["WORK"]
micro, cap = int(os.environ["MICRO"]), int(os.environ["CAP"])
with open(os.path.join(work, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
CACHE = ("k", "v", "cross_k", "cross_v")
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
dm = shd.device_mesh(mesh)
grads_of = Optimizer(lambda p: {}, lambda g, st, p: (g, st))
full = lambda tree: tree_map(lambda t: t.full_tensor().numpy(), tree)
names = lambda t: [str(p) for p in t.placements]
model = build_model(get_reduced("whisper-base"))
params = params_from_jax(inp["params"], "cpu")
batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
plan = plan_train_program(model, n_data=2)
out = {}
with TableIndex(model.cfg.vocab):
    step, _ = lower_to_pjit(plan, model, mesh, grads_of, batch_shapes=batch, microbatch=micro)
    g, _, met = step(*step.place(params, {}, batch))
    out["grads"], out["loss"] = full(g), float(met["loss"])
    opt = AdamW(lr=float(os.environ["LR"]))
    step, _ = lower_to_pjit(plan, model, mesh, opt, batch_shapes=batch, microbatch=micro)
    placed = step.place(params, opt.init(params), batch)
    out["emb_placements"] = names(placed[0]["emb"])
    with shd.comm_bytes() as comm:
        new_p, _, met = step(*placed)
    out["adamw_params"], out["adamw_loss"] = full(new_p), float(met["loss"])
    out["comm"] = comm.by_kind()
    out["train_lookups"] = list(lookups["vocab_parallel"])
    if dist.get_rank() == 0:
        g1, _, met1 = make_train_step(model, grads_of, microbatch=micro)[0](params, {}, batch)
        out["one_device"] = {"grads": tree_map(lambda t: t.numpy(), g1),
                             "loss": float(met1["loss"])}

    def cache_of(c):
        want = shd.cache_specs({k: c[k] for k in CACHE}, mesh, model.cfg)
        return {"full": {k: c[k].full_tensor().numpy() for k in CACHE}, "len": c["len"],
                "placements": {k: names(c[k]) for k in CACHE},
                "cache_specs": {k: [str(p) for p in shd.placements(dm, want[k])] for k in CACHE}}

    # prefill over the mesh, then decode steps fed JAX's greedy tokens
    pp = shd.shard_tree(params, shd.tree_param_specs(params, mesh), dm)
    place = lambda name, t: shd.shard_tree(
        {name: t}, shd.batch_specs({name: (t.shape, t.dtype)}, mesh), dm)[name]
    lookups["vocab_parallel"].clear()
    with shd.dtensor_scope(pp):
        cache = make_prefill_step(model, cap)(pp, {"frames": place("frames",
                                                                   torch.from_numpy(inp["frames"]))})
        out["prefill"] = cache_of(cache)
        serve = make_serve_step(model)
        out["decode"] = []
        for tok in inp["fed"]:
            nxt, logits, cache = serve(pp, cache, place("tokens", torch.from_numpy(tok)))
            out["decode"].append((nxt.full_tensor().numpy(), logits.full_tensor().numpy()))
        out["decode_cache"] = cache_of(cache)
    out["serve_lookups"] = list(lookups["vocab_parallel"])
out["table_index"] = lookups["table_index"]
with open(os.path.join(work, f"rank{dist.get_rank()}.pkl"), "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
'''

#: RWKV's lookups over the same mesh: the sharded train step's, then a
#: prefill and a decode step on the placed weights, beside the one-device
#: port's on rank 0
RWKV_SCRIPT = '''
import datetime, os, pickle
import torch, torch.distributed as dist

dist.init_process_group("gloo", init_method="file://" + os.environ["INIT_FILE"],
                        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.configs import get_reduced
from repro_torch.frontends.tensor import lower_to_pjit, plan_train_program
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import sharding as shd
from repro_torch.models.api import build_model, make_train_step
from repro_torch.train.optimizer import Optimizer
''' + LOOKUPS + '''
work = os.environ["WORK"]
with open(os.path.join(work, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
dm = shd.device_mesh(mesh)
model = build_model(get_reduced("rwkv6-1.6b"))
params = model.init(torch.Generator("cpu").manual_seed(0))
batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
grads_of = Optimizer(lambda p: {}, lambda g, st, p: (g, st))
out = {}
with TableIndex(model.cfg.vocab):
    step, _ = lower_to_pjit(plan_train_program(model, n_data=2), model, mesh, grads_of,
                            batch_shapes=batch, microbatch=2)
    placed = step.place(params, {}, batch)
    out["emb_placements"] = [str(p) for p in placed[0]["emb"].placements]
    g, _, met = step(*placed)
    out["loss"], out["emb_grad"] = float(met["loss"]), g["emb"].full_tensor().numpy()
    out["train_lookups"] = list(lookups["vocab_parallel"])
    lookups["vocab_parallel"].clear()
    pp = shd.shard_tree(params, shd.tree_param_specs(params, mesh), dm)
    toks = shd.shard_tree(batch, shd.batch_specs({k: (v.shape, v.dtype)
                                                  for k, v in batch.items()}, mesh), dm)["tokens"]
    with shd.dtensor_scope(pp):
        logits, state = model.prefill(pp, {"tokens": toks}, None)
        out["prefill"] = logits.full_tensor().numpy()
        logits, _ = model.decode(pp, state, toks[:, :1])
        out["decode"] = logits.full_tensor().numpy()
    out["serve_lookups"] = list(lookups["vocab_parallel"])
out["table_index"] = lookups["table_index"]
if dist.get_rank() == 0:
    g1, _, met1 = make_train_step(model, grads_of, microbatch=2)[0](params, {}, batch)
    tokens = batch["tokens"]
    logits, state = model.prefill(params, {"tokens": tokens}, None)
    out["one_device"] = {"loss": float(met1["loss"]), "emb_grad": g1["emb"].numpy(),
                         "prefill": logits.numpy(),
                         "decode": model.decode(params, state, tokens[:, :1])[0].numpy()}
with open(os.path.join(work, f"rank{dist.get_rank()}.pkl"), "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
'''


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _frames(b, seed):
    return np.random.default_rng(seed).normal(
        size=(b, S_ENC, get_reduced(ARCH).d_model)).astype(np.float32)


def _ranks(script, work, **env):
    ranks = run_ranks(script, WORLD, work, ROOT, timeout=TIMEOUT_S, WORK=str(work), **env)
    for r, (rc, _, err) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-4000:]}"
    return [pickle.loads((work / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's one-device train steps, prefill and decode steps, and the four
    port ranks on the same inputs."""
    work = tmp_path_factory.mktemp("whisper_ranks")
    jcfg = jax_reduced(ARCH)
    jmodel = jax_build(jcfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3)))
    batch = JaxTokenPipeline(vocab=jcfg.vocab, seq_len=S_DEC, global_batch=B, seed=5).batch_at(0)
    batch["mask"][:, -3:] = 0.0
    batch["mask"][1, :9] = 0.0  # microbatches of unequal counts
    batch["frames"] = _frames(B, 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads_of = JaxOptimizer(lambda p: {}, lambda g, st, p: (g, st))
    jg, _, jmet = jax_train_step(jmodel, grads_of, microbatch=MICRO)[0](params, {}, jb)
    jopt = JaxAdamW(lr=LR)
    jp, _, jmet2 = jax_train_step(jmodel, jopt, microbatch=MICRO)[0](
        params, jopt.init(params), jb)

    frames = _frames(B, 4)
    cache = jax.jit(jmodel.prefill, static_argnums=2)(params, {"frames": jnp.asarray(frames)},
                                                      CAP)
    want = {"grads": jax.device_get(jg), "loss": float(jmet["loss"]),
            "params": jax.device_get(jp), "adamw_loss": float(jmet2["loss"]),
            "prefill": jax.device_get(cache), "decode": []}
    decode, fed = jax.jit(jmodel.decode), [np.zeros((B, 1), np.int32)]
    for i in range(STEPS):
        logits, cache = decode(params, cache, jnp.asarray(fed[-1]))
        want["decode"].append(np.asarray(logits))
        if i + 1 < STEPS:
            fed.append(np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None])
    want["decode_cache"] = jax.device_get(cache)
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"params": params, "batch": batch, "frames": frames, "fed": fed}, f)
    out = _ranks(RANK_SCRIPT, work, MICRO=str(MICRO), LR=str(LR), CAP=str(CAP))
    return {"ranks": out, "params": params, "batch": batch, "jax": want, "fed": fed}


def test_sharded_whisper_loss_matches_jax_on_every_rank(run):
    want = run["jax"]["loss"]
    for r, out in enumerate(run["ranks"]):
        assert abs(out["loss"] - want) <= TOL * abs(want) + TOL, (r, out["loss"], want)
        assert abs(out["adamw_loss"] - run["jax"]["adamw_loss"]) <= TOL * abs(want) + TOL, r


def test_sharded_whisper_gradients_match_jax(run):
    got, want = _leaves(run["ranks"][0]["grads"]), _leaves(run["jax"]["grads"])
    assert set(got) == set(want)
    for k in want:
        w = want[k].astype(np.float64)
        assert np.linalg.norm(got[k] - w) <= GRAD_REL * np.linalg.norm(w) + 1e-12, k
    for k in ("/emb", "/dec_layers/cross/wk", "/enc_layers/attn/wq"):
        assert float(np.abs(got[k]).max()) > 0, k


def test_sharded_whisper_adamw_step_matches_jax(run):
    got, want = _leaves(run["ranks"][0]["adamw_params"]), _leaves(run["jax"]["params"])
    p0 = _leaves(run["params"])
    for k in want:
        u = want[k].astype(np.float64) - p0[k]
        d = got[k].astype(np.float64) - want[k]
        bound = UPD_RTOL * np.linalg.norm(u) + UPD_ATOL * LR * np.sqrt(u.size)
        assert np.linalg.norm(d) <= bound, (k, np.linalg.norm(d), bound)


def test_sharded_whisper_step_matches_the_one_device_step(run):
    r0 = run["ranks"][0]
    one = r0["one_device"]
    assert abs(r0["loss"] - one["loss"]) <= TOL * abs(one["loss"])
    got, want = _leaves(r0["grads"]), _leaves(one["grads"])
    for k in want:
        rel = np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-300)
        assert rel <= SHARD_REL, (k, rel)


def test_every_rank_assembles_the_same_whisper_results(run):
    r0 = run["ranks"][0]
    for out in run["ranks"][1:]:
        for part in ("grads", "adamw_params"):
            a, b = _leaves(r0[part]), _leaves(out[part])
            assert all(np.array_equal(a[k], b[k]) for k in a), part


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


def test_sharded_whisper_prefill_matches_jax(run):
    """The prefill's cache: every decoder layer's cross K/V of the encoded
    frames, the empty self-attention cache, len 0."""
    want = run["jax"]["prefill"]
    for out in run["ranks"]:
        got = out["prefill"]
        assert got["len"] == int(want["len"]) == 0
        for key in CACHE:
            assert got["full"][key].shape == want[key].shape, key
            _close(got["full"][key], want[key])
        assert not got["full"]["k"].any() and not got["full"]["v"].any()


def test_sharded_whisper_decode_steps_match_jax(run):
    """4 decode steps fed JAX's greedy tokens from a zero token: each step's
    logits and next token (cross-attention over frame 0 alone, as JAX's
    blocks give it), then the self cache they wrote."""
    want = run["jax"]
    for out in run["ranks"]:
        assert len(out["decode"]) == STEPS
        for i, ((nxt, logits), w) in enumerate(zip(out["decode"], want["decode"])):
            _close(logits, w)
            np.testing.assert_array_equal(nxt[:, 0], np.argmax(logits, -1))
            if i + 1 < STEPS:
                np.testing.assert_array_equal(nxt, run["fed"][i + 1])
        for key in CACHE:
            _close(out["decode_cache"]["full"][key], want["decode_cache"][key])
        assert out["decode_cache"]["len"] == int(want["decode_cache"]["len"]) == STEPS


def test_the_whisper_cache_keeps_the_cache_specs_placements(run):
    """The prefill's cache and the one decode steps carry come in
    ``cache_specs``' placements: batch over data, the heads over model (the
    self cache, and the cross K/V stacked from each layer's)."""
    for out in run["ranks"]:
        for cache in (out["prefill"], out["decode_cache"]):
            assert cache["placements"] == cache["cache_specs"]
    assert all(v == ["S(1)", "S(2)"] for v in run["ranks"][0]["prefill"]["cache_specs"].values())


def test_dryrun_counts_the_whisper_collectives_the_ranks_ran(run):
    batch = {k: torch.empty(v.shape, dtype=getattr(torch, str(v.dtype)), device="meta")
             for k, v in run["batch"].items()}
    got = dryrun.trace_cell(get_reduced(ARCH), "train_4k", (2, 2), ("data", "model"),
                            microbatch=MICRO, batch_override=batch)
    assert got["collective_by_kind"] == run["ranks"][0]["comm"]


# ---------------------------------------------------------------------------
# Queue 3 item 48: the lookups of a vocab-split table
# ---------------------------------------------------------------------------


def test_whisper_lookups_go_through_the_vocab_parallel_embedding(run):
    """Over the mesh ``emb`` is split by rows over model; every decoder
    lookup (two microbatches a step, two steps; one a decode step) goes
    through ``vocab_parallel_embedding``, and no index of the DTensor table
    is left."""
    for out in run["ranks"]:
        assert out["emb_placements"] == ["R", "S(0)"]
        assert out["train_lookups"] == [(B // MICRO, S_DEC)] * 4
        assert out["serve_lookups"] == [(B, 1)] * STEPS
        assert out["table_index"] == 0


@pytest.fixture(scope="module")
def rwkv(tmp_path_factory):
    work = tmp_path_factory.mktemp("rwkv_lookups")
    cfg = get_reduced("rwkv6-1.6b")
    batch = JaxTokenPipeline(vocab=cfg.vocab, seq_len=8, global_batch=B, seed=5).batch_at(0)
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"batch": batch}, f)
    return _ranks(RWKV_SCRIPT, work)


def test_rwkv_lookups_go_through_the_vocab_parallel_embedding(rwkv):
    """RWKV's loss, prefill and decode step over the mesh look up their
    tokens through ``vocab_parallel_embedding`` with no index of the DTensor
    table, and give the one-device port's loss, table gradient and logits."""
    one = rwkv[0]["one_device"]
    for out in rwkv:
        assert out["emb_placements"] == ["R", "S(0)"]
        assert out["train_lookups"] == [(B // MICRO, 8)] * MICRO
        assert out["serve_lookups"] == [(B, 8), (B, 1)]
        assert out["table_index"] == 0
        assert abs(out["loss"] - one["loss"]) <= TOL * abs(one["loss"])
        assert np.linalg.norm(out["emb_grad"] - one["emb_grad"]) <= \
            SHARD_REL * np.linalg.norm(one["emb_grad"])
        for key in ("prefill", "decode"):
            _close(out[key], one[key])


@pytest.mark.parametrize("family", ["rwkv", "encdec"])
def test_the_lookup_on_plain_tensors_keeps_the_index_bits(family, monkeypatch):
    """On plain tensors ``lm.embed`` is ``params["emb"][tokens]``: the
    family's loss, prefill and decode give the same bits through either."""
    arch = {"rwkv": "rwkv6-1.6b", "encdec": ARCH}[family]
    model = build_model(get_reduced(arch))
    params = model.init(torch.Generator("cpu").manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in JaxTokenPipeline(
        vocab=model.cfg.vocab, seq_len=8, global_batch=2, seed=5).batch_at(0).items()}
    assert torch.equal(lm.embed(params, model.cfg, batch["tokens"]),
                       params["emb"][batch["tokens"]])
    if family == "encdec":
        batch["frames"] = torch.from_numpy(_frames(2, 3))

    def outputs():
        with torch.no_grad():
            st = model.prefill(params, batch, 12)
            first = st[0] if family == "rwkv" else None
            st = st[1] if family == "rwkv" else st
            logits, _ = model.decode(params, st, batch["tokens"][:, :1])
            return [model.loss(params, batch), logits] + ([first] if first is not None else [])

    got = outputs()
    index = lambda p, cfg, tokens=None, embeds=None: p["emb"][tokens]
    monkeypatch.setattr(ssm, "embed", index)
    monkeypatch.setattr(whisper, "embed", index)
    for a, b in zip(got, outputs()):
        assert torch.equal(a, b)
