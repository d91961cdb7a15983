"""The MoE step over a mesh of ranks: the reduced Moonlight (8 experts) and
Mixtral (4 experts) expert-split over ``model``, and a 3-expert Moonlight on
the d_ff fallback, each sharded over a 2 × 2 (``data`` × ``model``) mesh of
four gloo ranks on the CPU, against the JAX package's one-device
``make_train_step``.

``layers.moe_block`` on DTensors runs per rank (``sharding.per_rank_moe``):
x gathered whole, so the capacity and each choice's place come from the
whole microbatch as GSPMD's global semantics give them, each rank's own
experts (or d_ff slice), the parts summed over ``model``.  The capacity
factor is 1.0, so choices are dropped; their count, over every layer and
microbatch, is JAX's (read from JAX's own ``keep`` through a
``jax.debug.callback`` on its dispatch) and the one-device step's.

Four rank processes (``launch.hermetic.run_ranks``) lower the same plan
with ``lower_to_pjit`` (microbatch 2), place the full weights and call the
step: once with an optimizer that hands the gradients back, once with
AdamW.  Rank 0 also runs the port's one-device step.  Tolerances are
``tests/test_torch_pjit_mesh.py``'s: against JAX loss rtol 1e-5, gradients
rtol 2e-4 and atol 1e-6·max|g|, an AdamW step's update ‖Δ‖ ≤ 2e-3·‖u‖ +
1e-2·lr·√n; against the port's one-device step loss rtol 1e-5 and each
gradient leaf ‖Δ‖/‖g‖ ≤ 1e-5 (the experts' parts summed in another order).
Beside them, the reduced RWKV6's sharded step, whose time scan runs per
rank (``sharding.per_rank_scan``), at the same tolerances.
"""

import contextlib
import pickle
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.api import make_train_step as jax_train_step  # noqa: E402
from repro.train.optimizer import AdamW as JaxAdamW  # noqa: E402
from repro.train.optimizer import Optimizer as JaxOptimizer  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.hermetic import run_ranks  # noqa: E402

from test_torch_spmd import ROOT  # noqa: E402

B, S, MICRO, LR, CF = 4, 32, 2, 3e-3, 1.0
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
UPD_RTOL, UPD_ATOL = 2e-3, 1e-2
SHARD_REL = 1e-5
WORLD, TIMEOUT_S = 4, 300
#: case → (arch, config overrides): expert-split where E divides model = 2,
#: else the d_ff fallback
CASES = {
    "moonlight-ep": ("moonshot-v1-16b-a3b", {}),
    "mixtral-ep": ("mixtral-8x7b", {}),
    "moonlight-dff": ("moonshot-v1-16b-a3b", {"n_experts": 3}),
}

RANK_SCRIPT = '''
import datetime, os, pickle
from dataclasses import replace
import torch, torch.distributed as dist

dist.init_process_group("gloo", init_method="file://" + os.environ["INIT_FILE"],
                        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.frontends.tensor import lower_to_pjit, plan_train_program
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers, sharding as shd
from repro_torch.models.api import build_model, make_train_step
from repro_torch.train.optimizer import AdamW, Optimizer, tree_map

work = os.environ["WORK"]
micro = int(os.environ["MICRO"])
with open(os.path.join(work, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
drops = [0]
route = layers.moe_route


def counted(*args, **kw):
    out = route(*args, **kw)
    drops[0] += int((~out[-1]).sum())
    return out


layers.moe_route = counted
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
grads_of = Optimizer(lambda p: {}, lambda g, st, p: (g, st))
full = lambda tree: tree_map(lambda t: t.full_tensor().numpy(), tree)
out = {}
for case, (arch, over) in inp["cases"].items():
    model = build_model(replace(get_reduced(arch), **over))
    params = params_from_jax(inp["params"][case], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    plan = plan_train_program(model, n_data=2)
    rec = {}
    step, _ = lower_to_pjit(plan, model, mesh, grads_of, batch_shapes=batch, microbatch=micro)
    drops[0] = 0
    g, _, met = step(*step.place(params, {}, batch))
    rec["drops"] = drops[0]
    rec["grads"], rec["loss"] = full(g), float(met["loss"])
    rec["grad_placements"] = tree_map(lambda t: [str(p) for p in t.placements], g)
    opt = AdamW(lr=float(os.environ["LR"]))
    step, _ = lower_to_pjit(plan, model, mesh, opt, batch_shapes=batch, microbatch=micro)
    placed = step.place(params, opt.init(params), batch)
    rec["local_shapes"] = tree_map(lambda t: tuple(t.to_local().shape), placed[0])
    with shd.comm_bytes() as comm:
        new_p, _, met = step(*placed)
    rec["adamw_params"], rec["adamw_loss"] = full(new_p), float(met["loss"])
    rec["comm"] = comm.by_kind()
    if dist.get_rank() == 0:
        one, _ = make_train_step(model, grads_of, microbatch=micro)
        drops[0] = 0
        g1, _, met1 = one(params, {}, batch)
        rec["one_device"] = {"grads": tree_map(lambda t: t.numpy(), g1),
                             "loss": float(met1["loss"]), "drops": drops[0]}
    out[case] = rec
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


class _Where:
    """``jnp`` as JAX's ``moe_block`` sees it, with its ``where`` recording
    the dropped choices: the first ``where`` of the block is ``slot =
    jnp.where(keep, …)``, and a ``jax.debug.callback`` adds up ``~keep``
    each time the block runs (inside the layers' ``lax.scan`` too)."""

    def __init__(self):
        self.drops = 0
        self.armed = False

    def __getattr__(self, name):
        return getattr(jnp, name)

    def where(self, cond, *args, **kw):
        if self.armed and getattr(cond, "dtype", None) == jnp.bool_ and cond.ndim == 1:
            self.armed = False

            def add(keep):
                self.drops += int((~np.asarray(keep)).sum())

            jax.debug.callback(add, cond)
        return jnp.where(cond, *args, **kw)


@contextlib.contextmanager
def jax_drops(monkeypatch):
    spy = _Where()
    block = jax_layers.moe_block

    def armed(*args, **kw):
        spy.armed = True
        return block(*args, **kw)

    with monkeypatch.context() as m:
        m.setattr(jax_layers, "jnp", spy)
        m.setattr(jax_layers, "moe_block", armed)
        yield spy


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's one-device steps and drops, and the four port ranks, per case."""
    work = tmp_path_factory.mktemp("moe_ranks")
    mp = pytest.MonkeyPatch()
    cases, params, want = {}, {}, {}
    batch = None
    try:
        for case, (arch, over) in CASES.items():
            over = dict(over, moe_capacity_factor=CF)
            cases[case] = (arch, over)
            jcfg = replace(jax_reduced(arch), **over)
            jmodel = jax_build(jcfg)
            p = jax.device_get(jmodel.init(jax.random.PRNGKey(3)))
            if batch is None:
                batch = JaxTokenPipeline(vocab=jcfg.vocab, seq_len=S, global_batch=B,
                                         seed=5).batch_at(0)
                batch["mask"][:, -3:] = 0.0
                batch["mask"][1, :9] = 0.0
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            grads_of = JaxOptimizer(lambda p: {}, lambda g, st, p: (g, st))
            jg, _, jmet = jax_train_step(jmodel, grads_of, microbatch=MICRO)[0](p, {}, jb)
            jopt = JaxAdamW(lr=LR)
            jp, _, _ = jax_train_step(jmodel, jopt, microbatch=MICRO)[0](p, jopt.init(p), jb)
            with jax_drops(mp) as spy:  # the microbatches as JAX's step cuts them
                for i in range(MICRO):
                    rows = slice(i * B // MICRO, (i + 1) * B // MICRO)
                    jax.block_until_ready(jmodel.loss(p, {k: v[rows] for k, v in jb.items()}))
            params[case] = p
            want[case] = {"grads": jax.device_get(jg), "loss": float(jmet["loss"]),
                          "params": jax.device_get(jp), "drops": spy.drops}
    finally:
        mp.undo()
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"cases": cases, "params": params, "batch": batch}, f)
    ranks = run_ranks(RANK_SCRIPT, WORLD, work, ROOT, timeout=TIMEOUT_S, WORK=str(work),
                      MICRO=str(MICRO), LR=str(LR))
    for r, (rc, _, err) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-4000:]}"
    out = [pickle.loads((work / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]
    return {"ranks": out, "params": params, "batch": batch, "jax": want}


@pytest.mark.parametrize("case", CASES)
def test_sharded_moe_loss_matches_jax_on_every_rank(run, case):
    want = run["jax"][case]["loss"]
    for r, out in enumerate(run["ranks"]):
        assert abs(out[case]["loss"] - want) <= LOSS_RTOL * abs(want), (r, out[case]["loss"])
        assert abs(out[case]["adamw_loss"] - want) <= LOSS_RTOL * abs(want), r


@pytest.mark.parametrize("case", CASES)
def test_sharded_moe_gradients_match_jax(run, case):
    got, want = _leaves(run["ranks"][0][case]["grads"]), _leaves(run["jax"][case]["grads"])
    assert set(got) == set(want)
    for k in want:
        w = want[k].astype(np.float64)
        np.testing.assert_allclose(got[k], w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * float(np.abs(w).max()), err_msg=k)
    assert float(np.abs(got["/layers/moe/router"]).max()) > 0


@pytest.mark.parametrize("case", CASES)
def test_sharded_moe_adamw_step_matches_jax(run, case):
    got = _leaves(run["ranks"][0][case]["adamw_params"])
    want, p0 = _leaves(run["jax"][case]["params"]), _leaves(run["params"][case])
    for k in want:
        u = want[k].astype(np.float64) - p0[k]
        d = got[k].astype(np.float64) - want[k]
        bound = UPD_RTOL * np.linalg.norm(u) + UPD_ATOL * LR * np.sqrt(u.size)
        assert np.linalg.norm(d) <= bound, (k, np.linalg.norm(d), bound)


@pytest.mark.parametrize("case", CASES)
def test_sharded_moe_matches_the_one_device_step(run, case):
    r0 = run["ranks"][0][case]
    one = r0["one_device"]
    assert abs(r0["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])
    got, want = _leaves(r0["grads"]), _leaves(one["grads"])
    for k in want:
        rel = np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-300)
        assert rel <= SHARD_REL, (k, rel)


@pytest.mark.parametrize("case", CASES)
def test_sharded_moe_drops_the_choices_jax_drops(run, case):
    """Every rank routes the whole microbatch: its dropped choices (over the
    layers and microbatches) are the one-device step's and JAX's, and
    there are some."""
    want = run["jax"][case]["drops"]
    assert want > 0
    assert run["ranks"][0][case]["one_device"]["drops"] == want
    for out in run["ranks"]:
        assert out[case]["drops"] == want


@pytest.mark.parametrize("case", CASES)
def test_every_rank_assembles_the_same_moe_results(run, case):
    r0 = run["ranks"][0][case]
    for out in run["ranks"][1:]:
        for part in ("grads", "adamw_params"):
            a, b = _leaves(r0[part]), _leaves(out[case][part])
            assert all(np.array_equal(a[k], b[k]) for k in a), part


@pytest.mark.parametrize("case", CASES)
def test_the_experts_keep_the_sharding_tables_placements(run, case):
    """Expert-split where E divides model = 2 (each rank E/2 experts),
    else w_gate/w_up split on d_ff and w_down on its d_ff rows; the
    experts' gradients come back in the leaves' placements plus ZeRO-2's
    data split, the router's replicated over model."""
    arch, over = CASES[case]
    cfg = replace(get_reduced(arch), **over)
    e, d, f, n = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.n_layers
    r0 = run["ranks"][0][case]
    moe = r0["local_shapes"]["layers"]["moe"]
    if e % 2 == 0:
        assert moe["w_gate"] == moe["w_up"] == (n, e // 2, d, f)
        assert moe["w_down"] == (n, e // 2, f, d)
        assert r0["grad_placements"]["layers"]["moe"]["w_gate"][1] == "S(1)"
    else:
        assert moe["w_gate"] == moe["w_up"] == (n, e, d, f // 2)
        assert moe["w_down"] == (n, e, f // 2, d)
        assert r0["grad_placements"]["layers"]["moe"]["w_gate"][1] == "S(3)"
    assert moe["router"] == (n, d, e)
    assert r0["grad_placements"]["layers"]["moe"]["router"][1] == "R"


@pytest.mark.parametrize("case", CASES)
def test_dryrun_counts_the_moe_collectives_the_ranks_ran(run, case):
    """The dry-run of the same cut cell on a fake world of 4 issues the
    ranks' collectives, kind by kind, with the same bytes."""
    arch, over = CASES[case]
    cfg = replace(get_reduced(arch), **over, moe_capacity_factor=CF)
    batch = {k: torch.empty(v.shape, dtype=getattr(torch, str(v.dtype)), device="meta")
             for k, v in run["batch"].items()}
    got = dryrun.trace_cell(cfg, "train_4k", (2, 2), ("data", "model"), microbatch=MICRO,
                            batch_override=batch)
    assert got["collective_by_kind"] == run["ranks"][0][case]["comm"]


RWKV_SCRIPT = '''
import datetime, os, pickle
import torch, torch.distributed as dist

dist.init_process_group("gloo", init_method="file://" + os.environ["INIT_FILE"],
                        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
                        timeout=datetime.timedelta(seconds=120))
from dataclasses import replace
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.frontends.tensor import lower_to_pjit, plan_train_program
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.api import build_model, make_train_step
from repro_torch.train.optimizer import Optimizer, tree_map

work = os.environ["WORK"]
with open(os.path.join(work, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
model = build_model(replace(get_reduced("rwkv6-1.6b"), remat=True))
params = params_from_jax(inp["params"], "cpu")
batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
grads_of = Optimizer(lambda p: {}, lambda g, st, p: (g, st))
step, _ = lower_to_pjit(plan_train_program(model, n_data=2), model,
                        make_mesh((2, 2), ("data", "model"), device="cpu"), grads_of,
                        batch_shapes=batch, microbatch=int(os.environ["MICRO"]))
g, _, met = step(*step.place(params, {}, batch))
out = {"grads": tree_map(lambda t: t.full_tensor().numpy(), g), "loss": float(met["loss"])}
one, _ = make_train_step(model, grads_of, microbatch=int(os.environ["MICRO"]))
g1, _, met1 = one(params, {}, batch)
out["one_device"] = {"grads": tree_map(lambda t: t.numpy(), g1), "loss": float(met1["loss"])}
with open(os.path.join(work, f"rank{dist.get_rank()}.pkl"), "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
'''


def test_sharded_rwkv_step_runs_its_scan_per_rank_as_one_device(tmp_path):
    """RWKV's time scan on DTensors runs per rank (``sharding.per_rank_scan``:
    each rank its own sequences and heads, u's gradient summed over the
    data ranks): the reduced RWKV6's sharded step (remat on, microbatch 2)
    against JAX's one-device step and the port's, at the tolerances
    above."""
    jcfg = replace(jax_reduced("rwkv6-1.6b"), remat=True)
    jmodel = jax_build(jcfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3)))
    batch = JaxTokenPipeline(vocab=jcfg.vocab, seq_len=S, global_batch=B, seed=5).batch_at(0)
    grads_of = JaxOptimizer(lambda p: {}, lambda g, st, p: (g, st))
    jg, _, jmet = jax_train_step(jmodel, grads_of, microbatch=MICRO)[0](
        params, {}, {k: jnp.asarray(v) for k, v in batch.items()})
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump({"params": params, "batch": batch}, f)
    ranks = run_ranks(RWKV_SCRIPT, WORLD, tmp_path, ROOT, timeout=TIMEOUT_S, WORK=str(tmp_path),
                      MICRO=str(MICRO))
    for r, (rc, _, err) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-4000:]}"
    r0 = pickle.loads((tmp_path / "rank0.pkl").read_bytes())
    want = float(jmet["loss"])
    assert abs(r0["loss"] - want) <= LOSS_RTOL * abs(want)
    assert abs(r0["loss"] - r0["one_device"]["loss"]) <= LOSS_RTOL * abs(want)
    got, jax_g = _leaves(r0["grads"]), _leaves(jax.device_get(jg))
    one = _leaves(r0["one_device"]["grads"])
    assert set(got) == set(jax_g)
    for k in jax_g:
        w = jax_g[k].astype(np.float64)
        np.testing.assert_allclose(got[k], w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * float(np.abs(w).max()), err_msg=k)
        rel = np.linalg.norm(got[k] - one[k]) / max(np.linalg.norm(one[k]), 1e-300)
        assert rel <= SHARD_REL, (k, rel)
