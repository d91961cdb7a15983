"""The ``multipod`` target and ``ElasticExecutor`` on ``torch.distributed``.

Four gloo rank processes on the CPU (``repro_torch.launch.hermetic.run_ranks``,
a ``file://`` rendezvous under a temporary directory) drive one
``ElasticExecutor`` through 4 → 2 → 1 → 4 workers, every rank calling
``run`` alike: the ranks of the current mesh run the plan, the others
receive its result from rank 0.  The JAX package's executor takes the same
steps in one subprocess with four host devices.  The data is
``tests/test_compiler.py``'s sales table, made from its seed.

Ported by name: ``test_compiler.py::TestPlanCache::test_elastic_executor_replan_hits_cache``
(in this process, one worker: the ``local`` target, no process group).

Tolerances: integers exact; floats rtol 1e-4 against the interpreter (as
the JAX test asks) and rtol 2e-4 against the JAX package; the multipod and
spmd targets share a lowering path and give the same bits.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.backends.multipod import ElasticExecutor as JElasticExecutor  # noqa: E402
from repro.compiler import PlanCache as JPlanCache  # noqa: E402
from repro.core.expr import col as jcol  # noqa: E402
from repro.frontends import dataflow as jdf  # noqa: E402
from repro.launch.hermetic import subprocess_env as jax_env  # noqa: E402
from repro_torch.backends.multipod import ElasticExecutor  # noqa: E402
from repro_torch.compiler import PlanCache  # noqa: E402
from repro_torch.core.expr import col  # noqa: E402
from repro_torch.frontends import dataflow as tdf  # noqa: E402
from repro_torch.launch.hermetic import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
#: the worker counts the executor steps through (the last a seen one)
STEPS = (4, 2, 1, 4)
TIMEOUT_S = 300

#: tests/test_compiler.py's sales table and query, under either package
DATA = '''
rng = np.random.default_rng(7)
ctx = Context(pad_to=256)
ctx.register("sales", {
    "region": rng.integers(0, 6, 2048).astype(np.int32),
    "amount": rng.gamma(2.0, 50.0, 2048).astype(np.float32),
    "year": rng.integers(2018, 2026, 2048).astype(np.int32),
})
q = (ctx.table("sales").filter(col("year") >= 2020)
     .group_by("region", max_groups=8)
     .agg(sum_("amount").as_("rev"), count_().as_("n")))


def lists(out):
    t = out[0]
    d = t.to_numpy() if hasattr(t, "to_numpy") else t
    return {k: np.asarray(v).ravel().tolist() for k, v in d.items()}
'''

PORT_SCRIPT = '''
import datetime, json, os
import numpy as np
import torch.distributed as dist

dist.init_process_group("gloo", init_method="file://" + os.environ["INIT_FILE"],
                        rank=int(os.environ["RANK"]),
                        world_size=int(os.environ["WORLD_SIZE"]),
                        timeout=datetime.timedelta(seconds=120))

from repro_torch.backends.multipod import ElasticExecutor
from repro_torch.compiler import PlanCache
from repro_torch.core.expr import col
from repro_torch.frontends.dataflow import Context, count_, sum_
''' + DATA + '''
cache = PlanCache()
ex = ElasticExecutor(program_builder=lambda: q.program("elastic_q"),
                     catalog=ctx.catalog(), cache=cache, device="cpu")
out = {"steps": [], "hits": [], "targets": []}
for workers in ''' + repr(STEPS) + ''':
    ex.on_resize(workers)
    out["steps"].append(lists(ex.run(ctx.sources("cpu"))))
    out["hits"].append(ex._current[1].cache_hit)
    out["targets"].append(ex._current[1].target)
out["multipod"] = lists([ctx.execute(q, target="multipod", parallel=4, device="cpu")])
out["spmd"] = lists([ctx.execute(q, target="spmd", parallel=4, device="cpu")])
out["interp"] = lists([ctx.execute(q, target="interp")])
out["cache"] = cache.stats
print("RESULTS" + json.dumps(out))
dist.barrier()
dist.destroy_process_group()
'''

JAX_SCRIPT = '''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import numpy as np

from repro.backends.multipod import ElasticExecutor
from repro.compiler import PlanCache
from repro.core.expr import col
from repro.frontends.dataflow import Context, count_, sum_
''' + DATA + '''
cache = PlanCache()
ex = ElasticExecutor(program_builder=lambda: q.program("elastic_q"),
                     catalog=ctx.catalog(), cache=cache)
out = {"steps": []}
for workers in ''' + repr(STEPS) + ''':
    ex.on_resize(workers)
    out["steps"].append(lists(ex.run(ctx.sources())))
print("RESULTS" + json.dumps(out))
'''


def _payload(text):
    line = [ln for ln in text.splitlines() if ln.startswith("RESULTS")][0]
    return json.loads(line[len("RESULTS"):])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Four port ranks and the JAX subprocess, side by side, once per process."""
    work = tmp_path_factory.mktemp("multipod_ranks")
    with open(work / "jax.out", "w") as jout, open(work / "jax.err", "w") as jerr:
        jax = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT], env=jax_env(ROOT),
                               stdout=jout, stderr=jerr)
        try:
            ranks = run_ranks(PORT_SCRIPT, WORLD, work, ROOT, timeout=TIMEOUT_S)
            jax.wait(timeout=TIMEOUT_S)
        finally:
            if jax.poll() is None:
                jax.kill()
                jax.wait()
    for r, (rc, _, err) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-4000:]}"
    assert jax.returncode == 0, (work / "jax.err").read_text()[-4000:]
    return {"ranks": [_payload(o) for _, o, _ in ranks],
            "jax": _payload((work / "jax.out").read_text())}


def _by_region(d):
    order = np.argsort(np.asarray(d["region"]))
    return {k: np.asarray(v)[order] for k, v in d.items()}


def _assert_close(got, want, rtol, what):
    got, want = _by_region(got), _by_region(want)
    np.testing.assert_array_equal(got["region"], want["region"], err_msg=what)
    np.testing.assert_array_equal(got["n"], want["n"], err_msg=what)
    np.testing.assert_allclose(got["rev"], want["rev"], rtol=rtol, err_msg=what)


def _sales(df, col):
    rng = np.random.default_rng(7)
    ctx = df.Context(pad_to=256)
    ctx.register("sales", {
        "region": rng.integers(0, 6, 2048).astype(np.int32),
        "amount": rng.gamma(2.0, 50.0, 2048).astype(np.float32),
        "year": rng.integers(2018, 2026, 2048).astype(np.int32),
    })
    q = (ctx.table("sales").filter(col("year") >= 2020)
         .group_by("region", max_groups=8)
         .agg(df.sum_("amount").as_("rev"), df.count_().as_("n")))
    return ctx, q


def test_elastic_executor_replan_hits_cache():
    ctx, q = _sales(tdf, col)
    cache = PlanCache()
    ex = ElasticExecutor(program_builder=lambda: q.program("elastic_q"),
                         catalog=ctx.catalog(), cache=cache, device="cpu")
    r1 = ex.plan(1)
    r2 = ex.plan(1)  # elastic event back to a seen topology: cached
    assert not r1.cache_hit
    assert r2.cache_hit
    assert r2.executable is r1.executable
    (out,) = ex.run(ctx.sources("cpu"))
    got = out.to_numpy()
    _assert_close(got, ctx.execute(q, target="interp"), 1e-4, "interp")
    jctx, jq = _sales(jdf, jcol)
    jex = JElasticExecutor(program_builder=lambda: jq.program("elastic_q"),
                           catalog=jctx.catalog(), cache=JPlanCache())
    _assert_close(got, jex.run(jctx.sources())[0].to_numpy(), 2e-4, "jax")


@pytest.mark.parametrize("step", range(len(STEPS)))
def test_every_rank_gets_the_answer_at_each_size(step, results):
    """At 4, 2, 1 and 4 workers every rank returns the interpreter's answer,
    the ranks outside the mesh by rank 0's broadcast, and the JAX
    executor's at the same worker count."""
    ranks = results["ranks"]
    want = ranks[0]["interp"]
    for r, res in enumerate(ranks):
        _assert_close(res["steps"][step], want, 1e-4, f"rank {r}")
        assert res["steps"][step] == ranks[0]["steps"][step], f"rank {r}"
    _assert_close(ranks[0]["steps"][step], results["jax"]["steps"][step], 2e-4, "jax")


def test_resize_replans_through_the_driver_and_hits_the_cache(results):
    """Each new worker count is a miss through the driver (``multipod``
    past one worker, ``local`` at one); the return to four workers is a
    plan-cache hit."""
    for res in results["ranks"]:
        assert res["targets"] == ["multipod", "multipod", "local", "multipod"]
        assert res["hits"] == [False, False, False, True]


def test_multipod_target_is_spmd(results):
    """``target="multipod"`` through the frontend: the spmd lowering path,
    the same bits on every rank."""
    for res in results["ranks"]:
        assert res["multipod"] == res["spmd"]
        _assert_close(res["multipod"], res["interp"], 1e-4, "interp")
