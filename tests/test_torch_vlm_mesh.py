"""The VLM family over a mesh of ranks: the reduced Qwen2-VL (2 layers, 4
heads and 2 KV heads of 32, M-RoPE sections (4, 6, 6)) sharded over a
2 × 2 (``data`` × ``model``) mesh of four gloo ranks on the CPU, against
the JAX package's one-device steps.

Four rank processes (``launch.hermetic.run_ranks``) lower the same plan
with ``lower_to_pjit`` (microbatch 2), place the full weights and call the
step on a batch of stub patch embeddings, image-then-text ``positions3``,
labels and mask (made as ``tests/test_torch_vlm.py`` makes them): once
with an optimizer that hands the gradients back, once with AdamW.  Rank 0
also runs the port's one-device step.  Then each rank prefills over the
mesh (``make_prefill_step`` on the weights placed by the sharding table,
``embeds`` and ``positions3`` by ``batch_specs``) and runs 4 decode steps
(``make_serve_step``) fed JAX's greedy tokens; decode rotates with 1-D
RoPE, as JAX's does (ROADMAP Queue 3 item 24).  A model rank holds 2 of
the 4 query heads and 1 of the 2 KV heads.

Tolerances: against JAX ``tests/test_torch_pjit_mesh.py``'s (loss rtol
1e-5; gradients rtol 2e-4, atol 1e-6·max|g|; an AdamW step's update by
‖Δ‖ ≤ 2e-3·‖u‖ + 1e-2·lr·√n); against the port's one-device step the loss
rtol 1e-5 and each gradient leaf ‖Δ‖/‖g‖ ≤ 1e-5; prefill's logits and
cache and the decode steps' logits ``tests/test_torch_vlm.py``'s TOL
(rtol/atol 2e-3).
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
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.hermetic import run_ranks  # noqa: E402

from test_torch_spmd import ROOT  # noqa: E402
from test_torch_vlm import image_then_text  # noqa: E402

ARCH = "qwen2-vl-7b"
B, S, MICRO, LR, GRID = 4, 32, 2, 3e-3, 4
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
UPD_RTOL, UPD_ATOL = 2e-3, 1e-2
SHARD_REL = 1e-5
TOL = 2e-3
PROMPT, CAP, STEPS = 16, 24, 4
WORLD, TIMEOUT_S = 4, 300

RANK_SCRIPT = '''
import dataclasses, datetime, os, pickle
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

work = os.environ["WORK"]
micro, cap = int(os.environ["MICRO"]), int(os.environ["CAP"])
with open(os.path.join(work, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
dm = shd.device_mesh(mesh)
grads_of = Optimizer(lambda p: {}, lambda g, st, p: (g, st))
full = lambda tree: tree_map(lambda t: t.full_tensor().numpy(), tree)
names = lambda t: [str(p) for p in t.placements]
model = build_model(get_reduced("qwen2-vl-7b"))
params = params_from_jax(inp["params"], "cpu")
batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
plan = plan_train_program(model, n_data=2)
out = {"slices": []}


def loss(p, mb):  # the model's loss, each microbatch slice's placements recorded
    out["slices"].append({k: (names(v), tuple(v.shape)) for k, v in mb.items()})
    return model.loss(p, mb)


step, _ = lower_to_pjit(plan, dataclasses.replace(model, loss=loss), mesh, grads_of,
                        batch_shapes=batch, microbatch=micro)
placed = step.place(params, {}, batch)
out["batch_placements"] = {k: names(v) for k, v in placed[2].items()}
g, _, met = step(*placed)
out["grads"], out["loss"] = full(g), float(met["loss"])
opt = AdamW(lr=float(os.environ["LR"]))
step, _ = lower_to_pjit(plan, model, mesh, opt, batch_shapes=batch, microbatch=micro)
placed = step.place(params, opt.init(params), batch)
with shd.comm_bytes() as comm:
    new_p, _, met = step(*placed)
out["adamw_params"], out["adamw_loss"] = full(new_p), float(met["loss"])
out["comm"] = comm.by_kind()
out["records"] = [(r["kind"], r["shape"]) for r in comm.records]
if dist.get_rank() == 0:
    g1, _, met1 = make_train_step(model, grads_of, microbatch=micro)[0](params, {}, batch)
    out["one_device"] = {"grads": tree_map(lambda t: t.numpy(), g1), "loss": float(met1["loss"])}


def cache_of(c):
    want = shd.cache_specs({k: c[k] for k in ("k", "v")}, mesh, model.cfg)
    return {"full": {k: c[k].full_tensor().numpy() for k in ("k", "v")}, "len": c["len"],
            "placements": {k: names(c[k]) for k in ("k", "v")},
            "cache_specs": {k: [str(p) for p in shd.placements(dm, want[k])] for k in ("k", "v")}}


# prefill over the mesh with embeds and positions3, then decode steps fed
# JAX's greedy tokens
pp = shd.shard_tree(params, shd.tree_param_specs(params, mesh), dm)
place = lambda b: shd.shard_tree(b, shd.batch_specs({k: (v.shape, v.dtype)
                                                     for k, v in b.items()}, mesh), dm)
prompt = place({k: torch.from_numpy(v) for k, v in inp["prompt"].items()})
out["prompt_placements"] = {k: names(v) for k, v in prompt.items()}
with shd.dtensor_scope(pp):
    logits, cache = make_prefill_step(model, cap)(pp, prompt)
    out["prefill"] = {"logits": logits.full_tensor().numpy(), "cache": cache_of(cache)}
    serve = make_serve_step(model)
    out["decode"] = []
    for tok in inp["fed"]:
        nxt, logits, cache = serve(pp, cache, place({"t": torch.from_numpy(tok)})["t"])
        out["decode"].append((nxt.full_tensor().numpy(), logits.full_tensor().numpy()))
    out["decode_cache"] = cache_of(cache)
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


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, cfg.d_model)).astype(np.float32),
            image_then_text(b, s, GRID))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's one-device train steps, prefill and decode steps, and the four
    port ranks on the same inputs."""
    work = tmp_path_factory.mktemp("vlm_ranks")
    jcfg = jax_reduced(ARCH)
    jmodel = jax_build(jcfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3)))
    embeds, pos3 = _inputs(jcfg, B, S, 6)
    pipe = JaxTokenPipeline(vocab=jcfg.vocab, seq_len=S, global_batch=B, seed=5).batch_at(0)
    batch = {"embeds": embeds, "positions3": pos3, "labels": pipe["labels"],
             "mask": pipe["mask"]}
    batch["mask"][:, -3:] = 0.0
    batch["mask"][1, :9] = 0.0  # microbatches of unequal counts
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads_of = JaxOptimizer(lambda p: {}, lambda g, st, p: (g, st))
    jg, _, jmet = jax_train_step(jmodel, grads_of, microbatch=MICRO)[0](params, {}, jb)
    jopt = JaxAdamW(lr=LR)
    jp, _, jmet2 = jax_train_step(jmodel, jopt, microbatch=MICRO)[0](
        params, jopt.init(params), jb)

    p_embeds, p_pos3 = _inputs(jcfg, B, PROMPT, 7)
    prompt = {"embeds": p_embeds, "positions3": p_pos3}
    logits, cache = jax.jit(jmodel.prefill, static_argnums=2)(
        params, {k: jnp.asarray(v) for k, v in prompt.items()}, CAP)
    want = {"grads": jax.device_get(jg), "loss": float(jmet["loss"]),
            "params": jax.device_get(jp), "adamw_loss": float(jmet2["loss"]),
            "prefill_logits": np.asarray(logits), "prefill_cache": jax.device_get(cache),
            "decode": []}
    decode, fed = jax.jit(jmodel.decode), []
    for _ in range(STEPS):
        fed.append(np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None])
        logits, cache = decode(params, cache, jnp.asarray(fed[-1]))
        want["decode"].append(np.asarray(logits))
    want["decode_cache"] = jax.device_get(cache)
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"params": params, "batch": batch, "prompt": prompt, "fed": fed}, f)
    ranks = run_ranks(RANK_SCRIPT, WORLD, work, ROOT, timeout=TIMEOUT_S, WORK=str(work),
                      MICRO=str(MICRO), LR=str(LR), CAP=str(CAP))
    for r, (rc, _, err) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-4000:]}"
    out = [pickle.loads((work / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]
    return {"ranks": out, "params": params, "batch": batch, "jax": want, "fed": fed}


def test_sharded_vlm_loss_matches_jax_on_every_rank(run):
    want = run["jax"]["loss"]
    for r, out in enumerate(run["ranks"]):
        assert abs(out["loss"] - want) <= LOSS_RTOL * abs(want), (r, out["loss"], want)
        assert abs(out["adamw_loss"] - run["jax"]["adamw_loss"]) <= LOSS_RTOL * abs(want), r


def test_sharded_vlm_gradients_match_jax(run):
    got, want = _leaves(run["ranks"][0]["grads"]), _leaves(run["jax"]["grads"])
    assert set(got) == set(want)
    for k in want:
        w = want[k].astype(np.float64)
        np.testing.assert_allclose(got[k], w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * float(np.abs(w).max()), err_msg=k)
    assert float(np.abs(got["/emb"]).max()) > 0  # the CE's table; embeds bypass the lookup


def test_sharded_vlm_adamw_step_matches_jax(run):
    got, want = _leaves(run["ranks"][0]["adamw_params"]), _leaves(run["jax"]["params"])
    p0 = _leaves(run["params"])
    for k in want:
        u = want[k].astype(np.float64) - p0[k]
        d = got[k].astype(np.float64) - want[k]
        bound = UPD_RTOL * np.linalg.norm(u) + UPD_ATOL * LR * np.sqrt(u.size)
        assert np.linalg.norm(d) <= bound, (k, np.linalg.norm(d), bound)


def test_sharded_vlm_step_matches_the_one_device_step(run):
    r0 = run["ranks"][0]
    one = r0["one_device"]
    assert abs(r0["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])
    got, want = _leaves(r0["grads"]), _leaves(one["grads"])
    for k in want:
        rel = np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-300)
        assert rel <= SHARD_REL, (k, rel)


def test_every_rank_assembles_the_same_vlm_results(run):
    r0 = run["ranks"][0]
    for out in run["ranks"][1:]:
        for part in ("grads", "adamw_params"):
            a, b = _leaves(r0[part]), _leaves(out[part])
            assert all(np.array_equal(a[k], b[k]) for k in a), part


def test_microbatch_slices_keep_their_batch_placements(run):
    """``embeds`` (B, S, D) is split on B over data, ``positions3`` (3, B, S)
    on dim 1; ``_microbatch_slices`` moves positions3's microbatch axis to
    the front, and each slice comes back in its batch leaf's placement."""
    for out in run["ranks"]:
        want = out["batch_placements"]
        assert want["embeds"] == ["S(0)", "R"] and want["positions3"] == ["S(1)", "R"]
        assert len(out["slices"]) == MICRO
        for sl in out["slices"]:
            assert {k: p for k, (p, _) in sl.items()} == want
            assert sl["embeds"][1] == (B // MICRO, S, get_reduced(ARCH).d_model)
            assert sl["positions3"][1] == (3, B // MICRO, S)


def test_no_allgather_of_vlm_logits(run):
    v = get_reduced(ARCH).vocab
    gathers = [rec for rec in run["ranks"][0]["records"] if rec[0] == "all_gather_into_tensor"]
    assert gathers
    assert not [rec for rec in gathers if len(rec[1]) == 3 and rec[1][-1] in (v, v // 2)]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


def test_sharded_vlm_prefill_matches_jax(run):
    """The prefill of stub embeddings at image-then-text positions3: the
    last position's logits and the K/V cache (K rotated by M-RoPE)."""
    want = run["jax"]
    for r, out in enumerate(run["ranks"]):
        assert out["prompt_placements"] == {"embeds": ["S(0)", "R"],
                                            "positions3": ["S(1)", "R"]}, r
        _close(out["prefill"]["logits"], want["prefill_logits"])
        cache = out["prefill"]["cache"]
        for leaf in ("k", "v"):
            assert cache["full"][leaf].shape == want["prefill_cache"][leaf].shape
            _close(cache["full"][leaf], want["prefill_cache"][leaf])
        assert cache["len"] == int(want["prefill_cache"]["len"]) == PROMPT


def test_sharded_vlm_decode_steps_match_jax(run):
    """4 decode steps fed JAX's greedy tokens: each step's logits and next
    token, then the cache they wrote (1-D RoPE at ``len``, as JAX's)."""
    want = run["jax"]
    for out in run["ranks"]:
        assert len(out["decode"]) == STEPS
        for i, ((nxt, logits), w) in enumerate(zip(out["decode"], want["decode"])):
            _close(logits, w)
            np.testing.assert_array_equal(nxt[:, 0], np.argmax(logits, -1))
            if i + 1 < STEPS:
                np.testing.assert_array_equal(nxt, run["fed"][i + 1])
        for leaf in ("k", "v"):
            _close(out["decode_cache"]["full"][leaf], want["decode_cache"][leaf])
        assert out["decode_cache"]["len"] == int(want["decode_cache"]["len"]) == PROMPT + STEPS


def test_the_vlm_cache_keeps_the_cache_specs_placements(run):
    """The prefill's cache and the one decode steps return come in
    ``cache_specs``' placements: batch over data, the KV heads over model."""
    for out in run["ranks"]:
        for cache in (out["prefill"]["cache"], out["decode_cache"]):
            assert cache["placements"] == cache["cache_specs"]
    assert run["ranks"][0]["prefill"]["cache"]["cache_specs"]["k"] == ["S(1)", "S(2)"]


def test_dryrun_counts_the_vlm_collectives_the_ranks_ran(run):
    """The dry-run of the same cut cell on a fake world of 4 issues the
    ranks' collectives, kind by kind, with the same bytes."""
    batch = {k: torch.empty(v.shape, dtype=getattr(torch, str(v.dtype)), device="meta")
             for k, v in run["batch"].items()}
    got = dryrun.trace_cell(get_reduced(ARCH), "train_4k", (2, 2), ("data", "model"),
                            microbatch=MICRO, batch_override=batch)
    assert got["collective_by_kind"] == run["ranks"][0]["comm"]
