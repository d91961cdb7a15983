"""The ``pjit`` target over a mesh of ranks: the reduced Qwen2-1.5B's train
step sharded over a 2 × 2 (``data`` × ``model``) mesh of four gloo ranks on
the CPU, against the JAX package's one-device ``make_train_step``.

Four rank processes (``launch.hermetic.run_ranks``) each lower the same
plan with ``lower_to_pjit`` (microbatch 2, so ``grad_constraint`` places
the f32 accumulator by ``tree_grad_specs``), place the full weights with
``ShardedStep.place`` and call the step: once with an optimizer that hands
the gradients back as the new parameters, once with AdamW.  Rank 0 also
runs the one-device step.  JAX initialises the weights (the QKV biases
then set to random values, as ``tests/test_torch_train.py`` does) and
runs its one-device step on the same batch.  The reduced config's 3 heads
and 1 KV head of 32 do not divide over ``model`` = 2, so the heads are
gathered before the attention (a divergence from GSPMD, ROADMAP Queue 3).

Tolerances: against JAX, tests/test_torch_train.py's (loss rtol 1e-5;
gradients rtol 2e-4, atol 1e-6·max|g|; an AdamW step's update by
‖Δ‖ ≤ 2e-3·‖u‖ + 1e-2·lr·√n); against the port's one-device step, the
loss rtol 1e-5 and each gradient leaf ‖Δ‖/‖g‖ ≤ 1e-5 (the partial sums
added across ranks in another order), as ``chip_smoke.py`` holds the card.
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
from repro_torch.frontends.tensor import PjitBackend, lower_to_pjit, plan_train_program  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.hermetic import run_ranks  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402

from test_torch_spmd import ROOT  # noqa: E402

ARCH, B, S, MICRO, LR = "qwen2-1.5b", 4, 32, 2, 3e-3
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
UPD_RTOL, UPD_ATOL = 2e-3, 1e-2
SHARD_REL = 1e-5
WORLD, TIMEOUT_S = 4, 240

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
from repro_torch.models.api import build_model, make_train_step
from repro_torch.train.optimizer import AdamW, Optimizer, tree_leaves, tree_map

work = os.environ["WORK"]
with open(os.path.join(work, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
model = build_model(get_reduced("qwen2-1.5b"))
params = params_from_jax(inp["params"], "cpu")
batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
plan = plan_train_program(model, n_data=2)
grads_of = Optimizer(lambda p: {}, lambda g, st, p: (g, st))
full = lambda tree: tree_map(lambda t: t.full_tensor().numpy(), tree)
out = {}

step, summary = lower_to_pjit(plan, model, mesh, grads_of, batch_shapes=batch,
                              microbatch=int(os.environ["MICRO"]))
g, _, met = step(*step.place(params, {}, batch))
out["grads"], out["loss"] = full(g), float(met["loss"])
out["grad_placements"] = tree_map(lambda t: [str(p) for p in t.placements], g)

opt = AdamW(lr=float(os.environ["LR"]))
step, _ = lower_to_pjit(plan, model, mesh, opt, batch_shapes=batch,
                        microbatch=int(os.environ["MICRO"]))
placed = step.place(params, opt.init(params), batch)
out["local_shapes"] = tree_map(lambda t: tuple(t.to_local().shape), placed[0])
out["moment_placements"] = tree_map(lambda t: [str(p) for p in t.placements], placed[1]["m"])
with shd.comm_bytes() as comm:
    new_p, new_s, met = step(*placed)
out["adamw_params"], out["adamw_loss"] = full(new_p), float(met["loss"])
out["param_placements"] = tree_map(lambda t: [str(p) for p in t.placements], new_p)
out["comm"] = comm.by_kind()
out["records"] = [(r["kind"], r["shape"], r["for"]) for r in comm.records]
if dist.get_rank() == 0:
    one, _ = make_train_step(model, grads_of, microbatch=int(os.environ["MICRO"]))
    g1, _, met1 = one(params, {}, batch)
    out["one_device"] = {"grads": tree_map(lambda t: t.numpy(), g1), "loss": float(met1["loss"])}
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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's one-device step and the four port ranks on the same inputs."""
    work = tmp_path_factory.mktemp("pjit_ranks")
    jcfg = jax_reduced(ARCH)
    params = jax.device_get(jax_build(jcfg).init(jax.random.PRNGKey(3)))
    attn = params["layers"]["attn"]
    rng = np.random.default_rng(3)
    for name in ("bq", "bk", "bv"):
        attn[name] = rng.normal(0, 0.5, attn[name].shape).astype(np.float32)
    batch = JaxTokenPipeline(vocab=jcfg.vocab, seq_len=S, global_batch=B, seed=5).batch_at(0)
    batch["mask"][:, -3:] = 0.0
    batch["mask"][1, :9] = 0.0  # microbatches of unequal counts: the per-slice mean matters
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"params": params, "batch": batch}, f)

    jmodel = jax_build(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads_of = JaxOptimizer(lambda p: {}, lambda g, st, p: (g, st))
    jstep, _ = jax_train_step(jmodel, grads_of, microbatch=MICRO)
    jg, _, jmet = jstep(params, {}, jb)
    jopt = JaxAdamW(lr=LR)
    jstep, _ = jax_train_step(jmodel, jopt, microbatch=MICRO)
    jp, _, jmet2 = jstep(params, jopt.init(params), jb)

    ranks = run_ranks(RANK_SCRIPT, WORLD, work, ROOT, timeout=TIMEOUT_S, WORK=str(work),
                      MICRO=str(MICRO), LR=str(LR))
    for r, (rc, _, err) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-4000:]}"
    out = [pickle.loads((work / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]
    return {"ranks": out, "params": params, "batch": batch,
            "jax": {"grads": jax.device_get(jg), "loss": float(jmet["loss"]),
                    "params": jax.device_get(jp), "adamw_loss": float(jmet2["loss"])}}


def test_sharded_loss_matches_jax_on_every_rank(run):
    want = run["jax"]["loss"]
    for r, out in enumerate(run["ranks"]):
        assert abs(out["loss"] - want) <= LOSS_RTOL * abs(want), (r, out["loss"], want)
        assert abs(out["adamw_loss"] - want) <= LOSS_RTOL * abs(want), r


def test_sharded_gradients_match_jax(run):
    got, want = _leaves(run["ranks"][0]["grads"]), _leaves(run["jax"]["grads"])
    assert set(got) == set(want)
    for k in want:
        w = want[k].astype(np.float64)
        np.testing.assert_allclose(got[k], w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * float(np.abs(w).max()), err_msg=k)


def test_sharded_adamw_step_matches_jax(run):
    got, want = _leaves(run["ranks"][0]["adamw_params"]), _leaves(run["jax"]["params"])
    p0 = _leaves(run["params"])
    for k in want:
        u = want[k].astype(np.float64) - p0[k]
        d = got[k].astype(np.float64) - want[k]
        bound = UPD_RTOL * np.linalg.norm(u) + UPD_ATOL * LR * np.sqrt(u.size)
        assert np.linalg.norm(d) <= bound, (k, np.linalg.norm(d), bound)


def test_sharded_step_matches_the_one_device_step(run):
    r0 = run["ranks"][0]
    one = r0["one_device"]
    assert abs(r0["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])
    got, want = _leaves(r0["grads"]), _leaves(one["grads"])
    for k in want:
        rel = np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-300)
        assert rel <= SHARD_REL, (k, rel)


def test_every_rank_assembles_the_same_results(run):
    r0 = run["ranks"][0]
    for out in run["ranks"][1:]:
        for part in ("grads", "adamw_params"):
            a, b = _leaves(r0[part]), _leaves(out[part])
            assert all(np.array_equal(a[k], b[k]) for k in a), part


def test_the_step_keeps_the_sharding_tables_placements(run):
    r0 = run["ranks"][0]
    shapes = r0["local_shapes"]
    assert shapes["emb"] == (256, 96)                      # vocab-split over model
    assert shapes["layers"]["mlp"]["w_gate"] == (2, 96, 128)   # d_ff column-split
    assert shapes["layers"]["mlp"]["w_down"] == (2, 128, 96)   # row-split
    assert shapes["layers"]["attn"]["wq"] == (2, 96, 48)       # inside a head: gathered later
    # ZeRO-1: a moment carries "data" beside its weight's "model" split
    assert r0["moment_placements"]["emb"] == ["S(1)", "S(0)"]
    # the new parameters come back in their own placement, the gradients in ZeRO-2's
    assert r0["param_placements"]["emb"] == ["R", "S(0)"]
    assert r0["grad_placements"]["emb"] == ["S(1)", "S(0)"]


def test_no_allgather_of_logits(run):
    """The vocab-split CE reduces per-row statistics only: no all-gather has
    a (…, V) or (…, V / 2) logits shape."""
    v = get_reduced(ARCH).vocab
    r0 = run["ranks"][0]
    gathers = [rec for rec in r0["records"] if rec[0] == "all_gather_into_tensor"]
    assert gathers  # ZeRO-1's parameter all-gathers are there
    assert not [rec for rec in gathers if len(rec[1]) == 3 and rec[1][-1] in (v, v // 2)]
    kinds = r0["comm"]
    assert kinds["reduce_scatter_tensor"]["calls"] > 0  # gradients to ZeRO-2's placement
    assert kinds["all_reduce"]["calls"] > 0             # row-split partial sums


def test_dryrun_counts_the_collectives_the_ranks_ran(run):
    """The dry-run of the same cut cell on a fake world of 4 issues the same
    collectives, kind by kind, with the same bytes, as the gloo ranks."""
    batch = {k: torch.empty(v.shape, dtype=getattr(torch, str(v.dtype)), device="meta")
             for k, v in run["batch"].items()}
    got = dryrun.trace_cell(get_reduced(ARCH), "train_4k", (2, 2), ("data", "model"),
                            microbatch=MICRO, batch_override=batch)
    assert got["collective_by_kind"] == run["ranks"][0]["comm"]


GATHER_SCRIPT = '''
import datetime, os
import torch, torch.distributed as dist
from torch.distributed.tensor import Shard, distribute_tensor

dist.init_process_group("gloo", init_method="file://" + os.environ["INIT_FILE"],
                        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import sharding as shd

shd.gather_through_c10d("CPU")  # the card's route for CUDA tensors, here on the CPU's
dm = shd.device_mesh(make_mesh((2, 2), ("data", "model"), device="cpu"))
full = torch.arange(96.0).reshape(8, 12)
x = distribute_tensor(full, dm, [Shard(0), Shard(1)], src_data_rank=None)
with shd.comm_bytes() as comm:
    got = x.full_tensor()
assert torch.equal(got, full), got
assert comm.by_kind()["all_gather_into_tensor"]["calls"] == 2, comm.by_kind()
dist.destroy_process_group()
'''


def test_gathers_through_c10d_give_the_functional_gathers_bits(tmp_path):
    """``sharding.gather_through_c10d``, which the card's gloo ranks need for
    CUDA tensors (ROADMAP Queue 3 item 33), registered for CPU tensors on
    four gloo ranks: DTensor's gathers through it assemble the tensor."""
    ranks = run_ranks(GATHER_SCRIPT, WORLD, tmp_path, ROOT, timeout=TIMEOUT_S)
    for r, (rc, _, err) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-4000:]}"


def test_a_larger_mesh_needs_its_process_group():
    model = build_model(get_reduced(ARCH))
    plan = plan_train_program(model, n_data=4)
    mesh = Mesh(None, (0, 1, 2, 3), ("data",), (4,), torch.device("cpu"))
    with pytest.raises(ValueError, match="process group"):
        lower_to_pjit(plan, model, mesh, AdamW(), batch_shapes={})
    with pytest.raises(ValueError, match="process group"):
        PjitBackend(model=model, mesh=mesh)


def test_dataclass_fields_are_jaxs():
    from repro.frontends.tensor import PjitBackend as JaxPjitBackend

    assert [f.name for f in dataclasses.fields(PjitBackend)] == [
        f.name for f in dataclasses.fields(JaxPjitBackend)]


def test_a_one_rank_mesh_keeps_the_plain_steps_bits(tmp_path):
    """On a one-rank (data 1, model 1) mesh over a gloo group the sharded
    step (microbatch 2, the ZeRO-2 constraint, AdamW) runs the plain code
    on every leaf: the loss and every new parameter are the plain step's
    bits (``tests/test_torch_cuda.py`` holds the same on the card)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding as shd
    from repro_torch.models.api import make_train_step
    from repro_torch.train.optimizer import tree_leaves

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        model = build_model(get_reduced(ARCH))
        params = model.init(torch.Generator().manual_seed(0))
        mesh = make_mesh((1, 1), ("data", "model"), group=dist.group.WORLD, device="cpu")
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(0, 512, (B, S)).astype(np.int32))
                 for k in ("tokens", "labels")}
        batch["mask"] = torch.ones((B, S), dtype=torch.float32)
        opt = AdamW(lr=LR)
        step, _ = lower_to_pjit(plan_train_program(model, 1), model, mesh, opt,
                                batch_shapes=batch, microbatch=MICRO)
        got = step(*step.place(params, opt.init(params), batch))
        want = make_train_step(model, opt, microbatch=MICRO)[0](params, opt.init(params), batch)
        assert torch.equal(got[2]["loss"], want[2]["loss"])
        for a, b in zip(tree_leaves(got[0]), tree_leaves(want[0])):
            assert torch.equal(a.to_local(), b)
        shd._map_specs(lambda spec, t: None, step.specs["params"], got[0])  # same tree
    finally:
        dist.destroy_process_group()
