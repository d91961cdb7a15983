"""The hybrid family over a mesh of ranks: the reduced Zamba2 (5 Mamba2
layers, the shared attention block at layers 0, 2 and 4) sharded over a
2 × 2 (``data`` × ``model``) mesh of four gloo ranks on the CPU, against the
JAX package's one-device steps.

Four rank processes (``launch.hermetic.run_ranks``) lower the same plan
with ``lower_to_pjit`` (microbatch 2), place the full weights and call the
step: once with an optimizer that hands the gradients back, once with
AdamW.  Rank 0 also runs the port's one-device step.  Then each rank
prefills over the mesh (``make_prefill_step`` on the weights placed by the
sharding table, the tokens by ``batch_specs``) and runs 4 decode steps
(``make_serve_step``) fed JAX's greedy tokens.  The Mamba2 mixer runs per
rank (``sharding.per_rank_mamba``): with the reduced config's 4 SSM heads
each model rank mixes 2; the ``three_heads`` case (``d_inner`` 192: 3
heads that do not divide over model = 2, remat on) takes its gather path.

Tolerances.  This model's f32 gradients are ill-conditioned: the reduced
Zamba2's one-device f32 step lies up to 1e-4·‖g‖ from its own f64 step,
the reduced Qwen2's 8.6e-7 (``tools/hybrid_mesh_probe.py
--conditioning``), and the one-device step exceeds
``tests/test_torch_pjit_mesh.py``'s elementwise gradient rule against JAX
on most leaves (ROADMAP Queue 3 item 45).  So against JAX: the loss rtol
1e-5, each gradient leaf ‖Δ‖ ≤ 1e-4·‖g‖ (``tests/test_torch_hybrid.py``'s
rule for this family), an AdamW step's update ‖Δ‖ ≤ 2e-3·‖u‖ +
1e-2·lr·√n; against the port's one-device step the loss rtol 1e-5 and
each leaf ‖Δ‖/‖g‖ within 1e-5 or 4× the one-device step's own distance
from its f64 step (whose CE and f32 accumulator are JAX's; the rule
``chip_smoke.py`` holds the families' training to); prefill's logits and
state and the decode steps' logits ``tests/test_torch_hybrid.py``'s
rtol/atol 2e-3.
"""

import pickle
from dataclasses import replace

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

ARCH = "zamba2-7b"
B, S, MICRO, LR = 4, 32, 2, 3e-3
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
UPD_RTOL, UPD_ATOL = 2e-3, 1e-2
SHARD_REL = 1e-5
F32_WITNESS = 4.0
SERVE_TOL = 2e-3
PROMPT, CAP, STEPS = 16, 24, 4
WORLD, TIMEOUT_S = 4, 300
#: case → config overrides: 4 SSM heads (2 a model rank), and 3 that do not
#: divide over model = 2 (the per-rank mixer gathers them), under remat
CASES = {"even_heads": {}, "three_heads": {"d_inner": 192, "remat": True}}
#: the shared block's leaves: one set of weights, its gradient summed over
#: the 3 attention points
SHARED = ("shared_attn", "shared_attn_norm", "shared_mlp", "shared_mlp_norm")

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


def state_of(st):
    keys = ("conv", "ssm", "k", "v")
    want = shd.cache_specs({k: st[k] for k in keys}, mesh, model.cfg)
    return {"full": {k: st[k].full_tensor().numpy() for k in keys}, "len": st["len"],
            "placements": {k: [str(p) for p in st[k].placements] for k in keys},
            "cache_specs": {k: [str(p) for p in shd.placements(dm, want[k])] for k in keys}}


out = {}
for case, over in inp["cases"].items():
    model = build_model(replace(get_reduced("zamba2-7b"), **over))
    params = params_from_jax(inp["params"][case], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    plan = plan_train_program(model, n_data=2)
    rec = {}
    step, _ = lower_to_pjit(plan, model, mesh, grads_of, batch_shapes=batch, microbatch=micro)
    g, _, met = step(*step.place(params, {}, batch))
    rec["grads"], rec["loss"] = full(g), float(met["loss"])
    opt = AdamW(lr=float(os.environ["LR"]))
    step, _ = lower_to_pjit(plan, model, mesh, opt, batch_shapes=batch, microbatch=micro)
    placed = step.place(params, opt.init(params), batch)
    with shd.comm_bytes() as comm:
        new_p, _, met = step(*placed)
    rec["adamw_params"], rec["adamw_loss"] = full(new_p), float(met["loss"])
    rec["comm"] = comm.by_kind()
    if dist.get_rank() == 0:
        # the one-device step, and in f64 (its CE and accumulator f32, as
        # JAX's) the witness of what f32 rounding does to its gradients
        rec["one_device"] = {}
        model64 = build_model(replace(model.cfg, dtype="float64"))
        params64 = params_from_jax(inp["params"][case], "cpu", dtype=torch.float64)
        for dtype, m_, p_ in (("f32", model, params), ("f64", model64, params64)):
            g1, _, met1 = make_train_step(m_, grads_of, microbatch=micro)[0](p_, {}, batch)
            rec["one_device"][dtype] = {"grads": tree_map(lambda t: t.numpy(), g1),
                                        "loss": float(met1["loss"])}

    # prefill over the mesh, then decode steps fed JAX's greedy tokens
    pp = shd.shard_tree(params, shd.tree_param_specs(params, mesh), dm)
    place_tokens = lambda t: shd.shard_tree(
        {"tokens": t}, shd.batch_specs({"tokens": (t.shape, t.dtype)}, mesh), dm)["tokens"]
    with shd.dtensor_scope(pp):
        logits, st = make_prefill_step(model, cap)(
            pp, {"tokens": place_tokens(torch.from_numpy(inp["prompt"]))})
        rec["prefill"] = {"logits": logits.full_tensor().numpy(), "state": state_of(st)}
        serve = make_serve_step(model)
        rec["decode"] = []
        for tok in inp["fed"]:
            nxt, logits, st = serve(pp, st, place_tokens(torch.from_numpy(tok)))
            rec["decode"].append((nxt.full_tensor().numpy(), logits.full_tensor().numpy()))
        rec["decode_state"] = state_of(st)
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


def _jax_params(jcfg, seed=3):
    """JAX's weights with the Mamba decays, skip and dt bias drawn as Mamba2
    initialises them (init makes them zeros and ones): A = −exp(A_log)
    with exp(A_log) ~ U(1, 16), dt_bias the inverse softplus of a dt
    log-uniform in [0.001, 0.1], D ~ N(1, 0.3).  With wider draws a
    chunk's decay sums reach hundreds: JAX's gradient is then NaN (ROADMAP
    Queue 3 item 43), and the f32 difference of two such cumulative sums
    makes either package's gradient move by about 3e-5 of its norm for a
    one-ulp change of its input (Queue 3 item 45)."""
    params = jax.device_get(jax_build(jcfg).init(jax.random.PRNGKey(seed)))
    mamba = params["layers"]["mamba"]
    rng = np.random.default_rng(seed)
    shape = mamba["A_log"].shape
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
    mamba["A_log"] = np.log(rng.uniform(1.0, 16.0, shape)).astype(np.float32)
    mamba["dt_bias"] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
    mamba["D"] = rng.normal(1.0, 0.3, shape).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's one-device train steps, prefill and decode steps, and the four
    port ranks, per case."""
    work = tmp_path_factory.mktemp("hybrid_ranks")
    batch = JaxTokenPipeline(vocab=get_reduced(ARCH).vocab, seq_len=S, global_batch=B,
                             seed=5).batch_at(0)
    batch["mask"][:, -3:] = 0.0
    batch["mask"][1, :9] = 0.0  # microbatches of unequal counts
    prompt = np.random.default_rng(4).integers(0, get_reduced(ARCH).vocab,
                                               (B, PROMPT)).astype(np.int32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads_of = JaxOptimizer(lambda p: {}, lambda g, st, p: (g, st))
    params, want, fed = {}, {}, []
    for case, over in CASES.items():
        jcfg = replace(jax_reduced(ARCH), **over)
        jmodel = jax_build(jcfg)
        p = _jax_params(jcfg)
        jg, _, jmet = jax_train_step(jmodel, grads_of, microbatch=MICRO)[0](p, {}, jb)
        jopt = JaxAdamW(lr=LR)  # the AdamW step's update of these gradients
        jp, _ = jax.jit(jopt.update)(jg, jopt.init(p), p)
        logits, st = jax.jit(jmodel.prefill, static_argnums=2)(
            p, {"tokens": jnp.asarray(prompt)}, CAP)
        decode = jax.jit(jmodel.decode)
        rec = {"grads": jax.device_get(jg), "loss": float(jmet["loss"]),
               "params": jax.device_get(jp), "prefill_logits": np.asarray(logits),
               "prefill_state": jax.device_get(st), "decode": []}
        steps = []
        for i in range(STEPS):
            tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
            if case == "even_heads":
                fed.append(tok)
            tok = fed[i]  # every case is fed the first case's tokens
            logits, st = decode(p, st, jnp.asarray(tok))
            steps.append(np.asarray(logits))
        rec["decode"], rec["decode_state"] = steps, jax.device_get(st)
        params[case], want[case] = p, rec
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"cases": CASES, "params": params, "batch": batch, "prompt": prompt,
                     "fed": fed}, f)
    ranks = run_ranks(RANK_SCRIPT, WORLD, work, ROOT, timeout=TIMEOUT_S, WORK=str(work),
                      MICRO=str(MICRO), LR=str(LR), CAP=str(CAP))
    for r, (rc, _, err) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-4000:]}"
    out = [pickle.loads((work / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]
    return {"ranks": out, "params": params, "batch": batch, "jax": want, "fed": fed}


@pytest.mark.parametrize("case", CASES)
def test_sharded_hybrid_loss_matches_jax_on_every_rank(run, case):
    want = run["jax"][case]["loss"]
    for r, out in enumerate(run["ranks"]):
        assert abs(out[case]["loss"] - want) <= LOSS_RTOL * abs(want), (r, out[case]["loss"])
        assert abs(out[case]["adamw_loss"] - want) <= LOSS_RTOL * abs(want), r


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


@pytest.mark.parametrize("case", CASES)
def test_sharded_hybrid_gradients_match_jax(run, case):
    """Every leaf, the shared block's among them (one set of weights whose
    gradient sums over its 3 attention points), within GRAD_REL of JAX's
    norm, as tests/test_torch_hybrid.py holds the one-device step."""
    got, want = _leaves(run["ranks"][0][case]["grads"]), _leaves(run["jax"][case]["grads"])
    assert set(got) == set(want)
    shared = [k for k in want if k.split("/")[1] in SHARED]
    assert len(shared) == 2 + 4 + 3  # the two norms, wq/wk/wv/wo, the SwiGLU's three
    for k in want:
        assert _rel(got[k], want[k].astype(np.float64)) <= GRAD_REL, (k, _rel(got[k], want[k]))
    for k in ("/layers/mamba/A_log", "/layers/mamba/conv_w", "/layers/mamba/in_proj",
              "/shared_attn/wq"):
        assert float(np.abs(got[k]).max()) > 0, k


@pytest.mark.parametrize("case", CASES)
def test_sharded_hybrid_adamw_step_matches_jax(run, case):
    got = _leaves(run["ranks"][0][case]["adamw_params"])
    want, p0 = _leaves(run["jax"][case]["params"]), _leaves(run["params"][case])
    for k in want:
        u = want[k].astype(np.float64) - p0[k]
        d = got[k].astype(np.float64) - want[k]
        bound = UPD_RTOL * np.linalg.norm(u) + UPD_ATOL * LR * np.sqrt(u.size)
        assert np.linalg.norm(d) <= bound, (k, np.linalg.norm(d), bound)


@pytest.mark.parametrize("case", CASES)
def test_sharded_hybrid_step_matches_the_one_device_step(run, case):
    """The loss within LOSS_RTOL of the one-device step's; each gradient
    leaf within SHARD_REL, or F32_WITNESS × the one-device step's own
    distance from its f64 step (the sum orders' rounding, amplified by this
    model's f32 backward)."""
    r0 = run["ranks"][0][case]
    one = r0["one_device"]["f32"]
    assert abs(r0["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])
    got, want = _leaves(r0["grads"]), _leaves(one["grads"])
    exact = _leaves(r0["one_device"]["f64"]["grads"])
    for k in want:
        witness = _rel(want[k].astype(np.float64), exact[k])
        assert _rel(got[k], want[k]) <= max(SHARD_REL, F32_WITNESS * witness), (k, witness)


@pytest.mark.parametrize("case", CASES)
def test_every_rank_assembles_the_same_hybrid_results(run, case):
    r0 = run["ranks"][0][case]
    for out in run["ranks"][1:]:
        for part in ("grads", "adamw_params"):
            a, b = _leaves(r0[part]), _leaves(out[case][part])
            assert all(np.array_equal(a[k], b[k]) for k in a), part


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=SERVE_TOL, atol=SERVE_TOL)


@pytest.mark.parametrize("case", CASES)
def test_sharded_hybrid_prefill_and_decode_match_jax(run, case):
    """The prefill's last-position logits and its whole state (per layer
    conv and SSM states, each attention point's K and V cache), then 4
    decode steps' logits and next tokens, and the state they leave."""
    want = run["jax"][case]
    for r, out in enumerate(run["ranks"]):
        got = out[case]
        _close(got["prefill"]["logits"], want["prefill_logits"])
        for when, key in (("prefill", "prefill_state"), ("decode_state", "decode_state")):
            st = got[when]["state"] if when == "prefill" else got[when]
            for leaf in ("conv", "ssm", "k", "v"):
                assert st["full"][leaf].shape == want[key][leaf].shape, (r, when, leaf)
                _close(st["full"][leaf], want[key][leaf])
            assert st["len"] == int(want[key]["len"])
        assert len(got["decode"]) == STEPS
        for i, ((nxt, logits), w) in enumerate(zip(got["decode"], want["decode"])):
            _close(logits, w)
            np.testing.assert_array_equal(nxt[:, 0], np.argmax(logits, -1))
            if i + 1 < STEPS and case == "even_heads":
                np.testing.assert_array_equal(nxt, run["fed"][i + 1])


@pytest.mark.parametrize("case", CASES)
def test_the_carried_state_keeps_the_cache_specs_placements(run, case):
    """A prefill's state and the state decode steps return come in
    ``cache_specs``' placements: batch over data; the SSM state split on
    its heads over model and the conv state on d_inner where the heads
    divide (the K/V caches on their heads)."""
    for out in run["ranks"]:
        for st in (out[case]["prefill"]["state"], out[case]["decode_state"]):
            assert st["placements"] == st["cache_specs"]
    st = run["ranks"][0][case]["prefill"]["state"]
    assert st["cache_specs"]["conv"] == ["S(1)", "S(3)"]
    assert st["cache_specs"]["ssm"] == (["S(1)", "S(2)"] if case == "even_heads"
                                        else ["S(1)", "S(3)"])


@pytest.mark.parametrize("case", CASES)
def test_dryrun_counts_the_hybrid_collectives_the_ranks_ran(run, case):
    """The dry-run of the same cut cell on a fake world of 4 issues the
    ranks' collectives, kind by kind, with the same bytes."""
    cfg = replace(get_reduced(ARCH), **CASES[case])
    batch = {k: torch.empty(v.shape, dtype=getattr(torch, str(v.dtype)), device="meta")
             for k, v in run["batch"].items()}
    got = dryrun.trace_cell(cfg, "train_4k", (2, 2), ("data", "model"), microbatch=MICRO,
                            batch_override=batch)
    assert got["collective_by_kind"] == run["ranks"][0][case]["comm"]
