"""The ``spmd`` target on ``torch.distributed`` against the JAX package's.

The port's SPMD backend is multi-controller: four gloo rank processes on
the CPU (``repro_torch.launch.hermetic.run_ranks``, a ``file://``
rendezvous under a temporary directory, so no port collides with another
test worker's) each run every case below on the same full sources.  The
JAX package's ``spmd`` target runs the same cases in one subprocess that
owns four host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``),
as ``tests/test_spmd_backend.py`` does.  Both run side by side, once per
pytest process that collects this file: once under ``--dist loadfile``,
which keeps a file on one xdist worker, and once per worker that takes
one of these tests under other ``--dist`` modes.  The data of every case is made from seeds by ``DATA``, the same code
in both scripts.

Ported by name (the JAX tests use 8 devices, these 4 ranks):
``tests/test_spmd_backend.py``, ``test_cost.py::TestSpmdCostChoice``,
``test_groupby_direct.py::TestSpmdDirectChoice``,
``test_join.py::TestSpmdJoin``, ``test_dict_encoding.py::TestSpmdStringKeys``,
``test_robust.py::test_spmd_shard_fault_recovers_to_oracle`` (at
``parallel=4``: a rank outside a 2-rank mesh takes no part in the plan)
and ``test_compiler.py``'s ``test_mesh_shortfall_fails_early``,
``test_one_entry_point_all_targets_identical`` and
``test_spmd_path_lowered_to_mesh_flavor``.

Tolerances: integers exact; floats rtol 2e-4 against JAX and numpy (f32
sums in other orders, tests/test_tpch.py's tolerance), rtol 1e-4 against
the interpreter as the JAX tests ask, and rtol 1e-5 against the port's
own ``local`` run at ``parallel=4`` (the collectives add the ranks'
partials in gloo's order).  ``collectives=False`` folds in the ``local``
target's order and must give its bits.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compiler import compile as jcompile  # noqa: E402
from repro.launch.hermetic import subprocess_env as jax_env  # noqa: E402
from repro.launch.mesh import make_mesh as jax_make_mesh  # noqa: E402
from repro.relational import tpch as jtpch  # noqa: E402
from repro_torch.compiler import PlanCache  # noqa: E402
from repro_torch.compiler import compile as tcompile  # noqa: E402
from repro_torch.core.expr import col  # noqa: E402
from repro_torch.core.passes.lower_vec import Catalog  # noqa: E402
from repro_torch.frontends.dataflow import Context, count_, sum_  # noqa: E402
from repro_torch.launch.hermetic import run_ranks  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh, world_size  # noqa: E402
from repro_torch.relational import tpch as ttpch  # noqa: E402

from test_dict_encoding import CITIES  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
QUERIES = sorted(jtpch.QUERIES)
VARIANTS = ("gather", "exchange")
#: the port's default strategy, bound on the JAX side too, so both packages
#: lower and run the same plans
STRATEGY = {"groupby": "direct", "join": "hash", "encode": "raw", "fuse": "fused"}
GROUP_KEYS = {"q1": ("l_returnflag", "l_linestatus"), "q4": ("o_orderpriority",),
              "q12": ("l_shipmode",)}
#: a timeout for the ranks and for the JAX subprocess (they take about a
#: minute together)
TIMEOUT_S = 600

#: the data of every case, made from seeds; the same code runs under both
#: packages (their frontends share this API)
DATA = '''
N = 4
out = {}


def lists(d):
    return {k: np.asarray(v).ravel().tolist() for k, v in d.items()}


def mesh_ops(res):
    return [o for o in res.program.opcodes() if o.startswith("mesh.")]


# TPC-H at sf=0.002 (tests/test_torch_tpch.py's tables) and
# tests/test_spmd_backend.py's
tables = tpch.generate(sf=0.002, seed=7)
ctx = tpch.make_context(tables)
c11 = tpch.make_context(tpch.generate(sf=0.002, seed=11), pad_to=1024)

# tests/test_compiler.py's sales table and query
rng = np.random.default_rng(7)
sc = Context(pad_to=256)
sc.register("sales", {
    "region": rng.integers(0, 6, 2048).astype(np.int32),
    "amount": rng.gamma(2.0, 50.0, 2048).astype(np.float32),
    "year": rng.integers(2018, 2026, 2048).astype(np.int32),
})
sq = (sc.table("sales").filter(col("year") >= 2020)
      .group_by("region", max_groups=8)
      .agg(sum_("amount").as_("rev"), count_().as_("n")))
scalar = sc.table("sales").filter(col("year") >= 2020).agg(sum_("amount").as_("rev"))

# test_cost.py::TestSpmdCostChoice
rng = np.random.default_rng(5)
n = 8192
sales = Context(pad_to=1024)
sales.register("sales", {
    "k": rng.integers(0, 2048, n).astype(np.int32),
    "amount": rng.gamma(2.0, 50.0, n).astype(np.float32),
})
caps = {"sales": sales.capacity("sales")}


def keyed(max_groups):
    return (sales.table("sales").group_by("k", max_groups=max_groups)
            .agg(sum_("amount").as_("rev"), count_().as_("n")))


hi = Catalog(capacities=caps, stats=Statistics.make(
    {"sales": TableStats.make(8192, 8.0, {"k": 2048})}))
lo = Catalog(capacities=caps, stats=Statistics.make(
    {"sales": TableStats.make(8192, 8.0, {"k": 4})}))

# test_groupby_direct.py::TestSpmdDirectChoice
rng = np.random.default_rng(21)
li = Context(pad_to=1024)
li.register("lineitem", {
    "rf": rng.integers(0, 3, n).astype(np.int32),
    "ls": rng.integers(0, 2, n).astype(np.int32),
    "qty": rng.integers(1, 50, n).astype(np.int32),
    "price": rng.gamma(2.0, 100.0, n).astype(np.float32),
    "ship": rng.integers(0, 2500, n).astype(np.int32),
})
gq = (li.table("lineitem").filter(col("ship") <= 2000)
      .group_by("rf", "ls", max_groups=8)
      .agg(sum_("qty").as_("sum_qty"), sum_("price").as_("rev"), count_().as_("cnt")))

# test_join.py::TestSpmdJoin
rng = np.random.default_rng(21)
jc = Context(pad_to=1024)
jc.register("orders", {
    "custkey": rng.integers(0, 128, n).astype(np.int32),
    "price": rng.gamma(2.0, 100.0, n).astype(np.float32),
})
jc.register("customer", {
    "ckey": np.arange(128).astype(np.int32),
    "nation": rng.integers(0, 8, 128).astype(np.int32),
})
jq = (jc.table("orders")
      .join(jc.table("customer"), left_on=("custkey",), right_on=("ckey",))
      .group_by("nation", max_groups=16)
      .agg(sum_("price").as_("rev"), count_().as_("n")))

# test_dict_encoding.py::TestSpmdStringKeys (make_city_ctx(n=2048, pad_to=256))
rng = np.random.default_rng(11)
cities = json.loads(os.environ["CITIES"])
city = Context(pad_to=256)
city.register("sales", {
    "city": np.array(cities, dtype=object)[rng.integers(0, len(cities), 2048)],
    "amount": rng.gamma(2.0, 50.0, 2048).astype(np.float32),
})
cq = (city.table("sales").group_by("city", max_groups=16)
      .agg(sum_("amount").as_("rev"), count_().as_("n")).order_by("city"))
'''

#: every rank of the port runs this; rank 0 prints the answers, every rank
#: a digest of its TPC-H answers
PORT_SCRIPT = '''
import datetime, hashlib, json, os, warnings
import numpy as np
import torch.distributed as dist

dist.init_process_group("gloo", init_method="file://" + os.environ["INIT_FILE"],
                        rank=int(os.environ["RANK"]),
                        world_size=int(os.environ["WORLD_SIZE"]),
                        timeout=datetime.timedelta(seconds=120))

from repro_torch.backends.spmd import SpmdBackend
from repro_torch.compiler import PlanCache, Statistics, TableStats, compile as cvm_compile
from repro_torch.core.expr import col
from repro_torch.core.passes import Parallelize
from repro_torch.core.passes.lower_vec import Catalog, LowerRelToVec
from repro_torch.frontends.dataflow import Context, count_, sum_
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs import DegradedWarning, tracing
from repro_torch.relational import tpch
from repro_torch.robust.inject import inject
''' + DATA + '''
def spmd(program, **kw):
    return cvm_compile(program, target="spmd", parallel=N, device="cpu", **kw)


for q in sorted(tpch.QUERIES):
    f = tpch.QUERIES[q](ctx)
    for label in ("gather", "exchange"):
        out[f"tpch/{q}/{label}"] = lists(f.collect(
            device="cpu", target="spmd", parallel=N, strategy={"grouped-recombine": label}))
    out[f"tpch/{q}/nocoll"] = lists(f.collect(device="cpu", target="spmd", parallel=N,
                                              collectives=False))
    out[f"tpch/{q}/local"] = lists(f.collect(device="cpu", parallel=N))

mesh = make_mesh((N,), ("workers",), device="cpu")
for q in ("q1", "q6", "q12"):
    program = Parallelize(n=N).apply(tpch.QUERIES[q](c11).program(q))
    program = LowerRelToVec(c11.catalog()).apply(program)
    compiled = SpmdBackend(mesh).compile(program)
    (o,) = compiled(c11.sources("cpu"))
    out["backend/" + q] = lists(o.to_numpy() if hasattr(o, "to_numpy") else o)
    out["backend/" + q + "_ops"] = mesh_ops(compiled)

res = spmd(keyed(2048).program(), catalog=hi, optimize="cost", cache=False)
out["cost/hi_strategy"] = dict(res.strategy)
out["cost/hi_mesh_ops"] = mesh_ops(res)
out["cost/hi_explain"] = res.explain()
res = spmd(keyed(8).program(), catalog=lo, optimize="cost", cache=False)
out["cost/lo_strategy"] = dict(res.strategy)
out["cost/lo_mesh_ops"] = mesh_ops(res)
out["cost/want"] = lists(sales.execute(keyed(2048), target="interp"))
for label in ("gather", "exchange"):
    res = spmd(keyed(2048).program(), catalog=hi, strategy={"grouped-recombine": label},
               cache=False)
    out["cost/" + label] = lists(res(sales.sources("cpu"))[0].to_numpy())
    out["cost/" + label + "_mesh_ops"] = mesh_ops(res)

res = spmd(gq.program(), catalog=li.catalog(), optimize="cost", cache=False)
out["direct/strategy"] = dict(res.strategy)
out["direct/ops"] = sorted(set(res.program.opcodes()))
out["direct/want"] = lists(li.execute(gq, target="interp"))
for label, strategy in (("sorted", {"groupby": "sorted"}), ("direct", {"groupby": "direct"}),
                        ("exchange", {"groupby": "direct", "grouped-recombine": "exchange"})):
    res = spmd(gq.program(), catalog=li.catalog(), strategy=strategy, cache=False)
    out["direct/" + label] = lists(res(li.sources("cpu"))[0].to_numpy())
    out["direct/" + label + "_ops"] = sorted(set(res.program.opcodes()))

res = spmd(jq.program(), catalog=jc.catalog(), optimize="cost", cache=False)
out["join/strategy"] = dict(res.strategy)
out["join/want"] = lists(jc.execute(jq, target="interp"))
for label in ("sorted", "hash"):
    # the JAX test's plan: its default group-by tier, so the join stays unfused
    res = spmd(jq.program(), catalog=jc.catalog(), strategy={"join": label, "groupby": "sorted"},
               cache=False)
    out["join/" + label] = lists(res(jc.sources("cpu"))[0].to_numpy())
    out["join/" + label + "_ops"] = sorted(set(res.program.opcodes()))

out["dict/want"] = lists(city.execute(cq, target="interp"))
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    out["dict/forced"] = lists(city.execute(cq, target="spmd", parallel=N, device="cpu",
                                            strategy={"groupby": "direct", "encode": "dict"}))
    out["dict/costed"] = lists(city.execute(cq, target="spmd", parallel=N, device="cpu",
                                            optimize="cost"))

out["chaos/want"] = lists(sc.execute(sq, target="interp"))
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    with inject("spmd.shard", mode="raise", times=1,
                seed=int(os.environ.get("REPRO_CHAOS_SEED", "0"))):
        result = sc.compile(sq, target="spmd", parallel=N, cache=PlanCache(), device="cpu")
        (got,) = result(sc.sources("cpu"))
out["chaos/got"] = lists(got.to_numpy())
out["chaos/degraded"] = list(result.degraded)
out["chaos/warned"] = sum(1 for w in caught if issubclass(w.category, DegradedWarning))

for target, parallel in (("local", None), ("spmd", N), ("interp", None)):
    out["entry/" + target] = lists(sc.execute(sq, target=target, parallel=parallel,
                                              device="cpu"))
out["entry/spmd_ops"] = mesh_ops(spmd(sq.program(), catalog=sc.catalog()))
out["entry/scalar_ops"] = mesh_ops(spmd(scalar.program(), catalog=sc.catalog()))

for q in ("q1", "q6"):
    res = ctx.compile(tpch.QUERIES[q](ctx), target="spmd", parallel=N, device="cpu",
                      cache=False)
    with tracing():
        res(ctx.sources("cpu"))
    out["taps/" + q] = sorted([o.opcode, o.rows_in, o.rows_out]
                              for o in res.profile.observations
                              if o.opcode == "mesh.MeshExecute")

print("DIGEST" + hashlib.sha256(json.dumps(
    {k: v for k, v in out.items() if k.startswith("tpch/")}, sort_keys=True).encode()).hexdigest())
if dist.get_rank() == 0:
    print("RESULTS" + json.dumps(out))
dist.barrier()
dist.destroy_process_group()
'''

#: the JAX package's side of the cases that are held against it
JAX_SCRIPT = '''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, warnings
import numpy as np

from repro.backends.spmd import SpmdBackend
from repro.compiler import Statistics, TableStats, compile as cvm_compile
from repro.core.expr import col
from repro.core.passes import Parallelize
from repro.core.passes.lower_vec import Catalog, LowerRelToVec
from repro.frontends.dataflow import Context, count_, sum_
from repro.launch.mesh import make_mesh
from repro.obs import tracing
from repro.relational import tpch
''' + DATA + '''
STRATEGY = ''' + repr(STRATEGY) + '''


def spmd(program, **kw):
    return cvm_compile(program, target="spmd", parallel=N, **kw)


for q in sorted(tpch.QUERIES):
    for label in ("gather", "exchange"):
        out[f"tpch/{q}/{label}"] = lists(tpch.QUERIES[q](ctx).collect(
            target="spmd", parallel=N, strategy=dict(STRATEGY, **{"grouped-recombine": label})))

mesh = make_mesh((N,), ("workers",))
for q in ("q1", "q6", "q12"):
    program = Parallelize(n=N).apply(tpch.QUERIES[q](c11).program(q))
    program = LowerRelToVec(c11.catalog()).apply(program)
    (o,) = SpmdBackend(mesh).compile(program)(c11.sources())
    out["backend/" + q] = lists(o.to_numpy() if hasattr(o, "to_numpy") else o)

out["cost/hi_strategy"] = dict(spmd(keyed(2048).program(), catalog=hi, optimize="cost",
                                    cache=False).strategy)
out["cost/lo_strategy"] = dict(spmd(keyed(8).program(), catalog=lo, optimize="cost",
                                    cache=False).strategy)
out["direct/strategy"] = dict(spmd(gq.program(), catalog=li.catalog(), optimize="cost",
                                   cache=False).strategy)
out["join/strategy"] = dict(spmd(jq.program(), catalog=jc.catalog(), optimize="cost",
                                 cache=False).strategy)
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    out["dict/forced"] = lists(city.execute(cq, target="spmd", parallel=N,
                                            strategy={"groupby": "direct", "encode": "dict"}))
    out["dict/costed"] = lists(city.execute(cq, target="spmd", parallel=N, optimize="cost"))
out["entry/spmd"] = lists(sc.execute(sq, target="spmd", parallel=N))

for q in ("q1", "q6"):
    res = ctx.compile(tpch.QUERIES[q](ctx), target="spmd", parallel=N, strategy=STRATEGY,
                      cache=False)
    with tracing():
        res(ctx.sources())
    out["taps/" + q] = sorted([o.opcode, o.rows_in, o.rows_out]
                              for o in res.profile.observations
                              if o.opcode == "mesh.MeshExecute")
print("RESULTS" + json.dumps(out))
'''


def _payload(text: str, tag: str = "RESULTS"):
    line = [ln for ln in text.splitlines() if ln.startswith(tag)][0]
    return line[len(tag):] if tag == "DIGEST" else json.loads(line[len(tag):])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Four port ranks and the JAX subprocess, side by side, once per process."""
    work = tmp_path_factory.mktemp("spmd_ranks")
    env = jax_env(ROOT, CITIES=json.dumps(CITIES))
    with open(work / "jax.out", "w") as jout, open(work / "jax.err", "w") as jerr:
        jax = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT], env=env, stdout=jout,
                               stderr=jerr)
        try:
            ranks = run_ranks(PORT_SCRIPT, WORLD, work, ROOT, timeout=TIMEOUT_S,
                              CITIES=json.dumps(CITIES),
                              REPRO_CHAOS_SEED=os.environ.get("REPRO_CHAOS_SEED", "0"))
            jax.wait(timeout=TIMEOUT_S)
        finally:
            if jax.poll() is None:
                jax.kill()
                jax.wait()
    for r, (rc, _, err) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-4000:]}"
    assert jax.returncode == 0, (work / "jax.err").read_text()[-4000:]
    return {"port": _payload(ranks[0][1]), "jax": _payload((work / "jax.out").read_text()),
            "digests": [_payload(o, "DIGEST") for _, o, _ in ranks]}


def _sorted(d, keys):
    d = {k: np.asarray(v).ravel() for k, v in d.items()}
    if not keys:
        return d
    order = np.lexsort([d[k] for k in reversed(keys)])
    return {k: v[order] for k, v in d.items()}


def _assert_close(got, want, keys, rtol, what):
    got, want = _sorted(got, keys), _sorted(want, keys)
    assert set(got) == set(want), what
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        if w.dtype.kind in "iub" and g.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{k}")
        elif w.dtype.kind in "US":
            np.testing.assert_array_equal(g.astype(str), w, err_msg=f"{what}.{k}")
        else:
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=rtol, err_msg=f"{what}.{k}")


@pytest.fixture(scope="module")
def tables():
    return jtpch.generate(sf=0.002, seed=7)


@pytest.fixture(scope="module")
def jctx(tables):
    return jtpch.make_context(tables)


@pytest.fixture(scope="module")
def tctx(tables):
    return ttpch.make_context(tables)


def _mesh(ranks, device="cpu", backend="gloo"):
    """A mesh for compiling only: its ranks, no process group."""
    ranks = tuple(ranks)
    return Mesh(None, ranks, ("workers",), (len(ranks),), torch.device(device), backend)


# ---------------------------------------------------------------------------
# TPC-H at sf=0.002 on four ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("qname", QUERIES)
def test_tpch_matches_jax_spmd(qname, variant, results, tables):
    """Each query on four ranks against the JAX package's spmd target on
    four devices and numpy; and against the port's local run at
    ``parallel=4``, which it folds in another order only where a
    collective adds the ranks' partials."""
    keys = GROUP_KEYS.get(qname, ())
    got = results["port"][f"tpch/{qname}/{variant}"]
    _assert_close(got, results["jax"][f"tpch/{qname}/{variant}"], keys, 2e-4, "jax spmd")
    _assert_close(got, jtpch.REFERENCES[qname](tables), keys, 2e-4, "numpy")
    _assert_close(got, results["port"][f"tpch/{qname}/local"], keys, 1e-5, "local")


@pytest.mark.parametrize("qname", QUERIES)
def test_collectives_off_gives_local_bits(qname, results):
    """Without collectives every combine is gathered and folded in rank
    order, as the local target folds its chunks: the same bits."""
    assert results["port"][f"tpch/{qname}/nocoll"] == results["port"][f"tpch/{qname}/local"]


def test_every_rank_returns_the_same_result(results):
    assert len(results["digests"]) == WORLD
    assert len(set(results["digests"])) == 1, results["digests"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("qname", QUERIES)
def test_lowered_program_matches_jax(qname, variant, jctx, tctx):
    """The lowered spmd programs, nested MeshExecute bodies included, are
    JAX's instruction for instruction, with the same parameters.  Neither
    side needs its ranks or devices to lower."""
    strategy = dict(STRATEGY, **{"grouped-recombine": variant})
    jprog = jcompile(jtpch.QUERIES[qname](jctx).program(), target="spmd", parallel=WORLD,
                     catalog=jctx.catalog(with_stats=True), use_kernels=True,
                     mesh=jax_make_mesh((1,), ("workers",)), strategy=strategy,
                     cache=False).program
    tprog = tcompile(ttpch.QUERIES[qname](tctx).program(), target="spmd", parallel=WORLD,
                     catalog=tctx.catalog(), mesh=_mesh(range(WORLD)), strategy=strategy,
                     device="cpu", cache=False).program
    assert tprog.opcodes() == jprog.opcodes()
    if variant == "exchange" and qname in ("q1", "q4"):
        assert "mesh.ExchangeByKey" in tprog.opcodes()
    jins = [i for p in jprog.walk() for i in p.body]
    tins = [i for p in tprog.walk() for i in p.body]
    for ji, ti in zip(jins, tins):
        assert sorted(k for k, _ in ti.params) == sorted(k for k, _ in ji.params), ji.opcode
        for name, value in ji.params:
            if name != "P":
                assert repr(ti.param(name)) == repr(value), (ji.opcode, name)


# ---------------------------------------------------------------------------
# tests/test_spmd_backend.py
# ---------------------------------------------------------------------------


def _backend_ref(qname):
    return jtpch.REFERENCES[qname](jtpch.generate(sf=0.002, seed=11))


def test_spmd_q6_matches_reference(results):
    got = results["port"]["backend/q6"]
    np.testing.assert_allclose(got["revenue"], _backend_ref("q6")["revenue"], rtol=2e-4)
    np.testing.assert_allclose(got["revenue"], results["jax"]["backend/q6"]["revenue"],
                               rtol=2e-4)


def test_spmd_q1_matches_reference(results):
    got = results["port"]["backend/q1"]
    want = _backend_ref("q1")
    order_g = np.lexsort([got["l_linestatus"], got["l_returnflag"]])
    order_w = np.lexsort([want["l_linestatus"], want["l_returnflag"]])
    np.testing.assert_allclose(np.asarray(got["sum_disc_price"])[order_g],
                               want["sum_disc_price"][order_w], rtol=2e-4)
    np.testing.assert_array_equal(np.asarray(got["count_order"])[order_g],
                                  want["count_order"][order_w])
    _assert_close(got, results["jax"]["backend/q1"], GROUP_KEYS["q1"], 2e-4, "jax")


def test_spmd_q12_matches_reference(results):
    got = results["port"]["backend/q12"]
    want = _backend_ref("q12")
    order = np.argsort(got["l_shipmode"])
    np.testing.assert_array_equal(np.asarray(got["high_line_count"])[order],
                                  want["high_line_count"])
    np.testing.assert_array_equal(np.asarray(got["low_line_count"])[order],
                                  want["low_line_count"])
    _assert_close(got, results["jax"]["backend/q12"], GROUP_KEYS["q12"], 2e-4, "jax")


def test_collective_rewrite_applied(results):
    """The scalar-agg query must lower its combine into a mesh.AllReduce."""
    assert "mesh.AllReduce" in results["port"]["backend/q6_ops"]


# ---------------------------------------------------------------------------
# test_cost.py::TestSpmdCostChoice
# ---------------------------------------------------------------------------


class TestSpmdCostChoice:
    def test_high_cardinality_selects_exchange(self, results):
        r = results["port"]
        assert r["cost/hi_strategy"]["grouped-recombine"] == "exchange"
        assert results["jax"]["cost/hi_strategy"]["grouped-recombine"] == "exchange"
        assert "mesh.ExchangeByKey" in r["cost/hi_mesh_ops"]

    def test_low_cardinality_selects_gather(self, results):
        r = results["port"]
        assert r["cost/lo_strategy"]["grouped-recombine"] == "gather"
        assert results["jax"]["cost/lo_strategy"]["grouped-recombine"] == "gather"
        assert "mesh.ExchangeByKey" not in r["cost/lo_mesh_ops"]

    def test_both_plans_match_interp(self, results):
        r = results["port"]
        for label in VARIANTS:
            _assert_close(r["cost/" + label], r["cost/want"], ("k",), 1e-4, label)
        # the exchange plan really recombines inside the mesh, not by gather
        assert "mesh.ExchangeByKey" in r["cost/exchange_mesh_ops"]

    def test_explain_shows_candidates_and_decision(self, results):
        text = results["port"]["cost/hi_explain"]
        assert "cost search" in text
        assert "grouped-recombine=gather" in text
        assert "grouped-recombine=exchange" in text
        assert "winner" in text


# ---------------------------------------------------------------------------
# test_groupby_direct.py::TestSpmdDirectChoice
# ---------------------------------------------------------------------------


class TestSpmdDirectChoice:
    def test_cost_selects_direct_on_spmd(self, results):
        r = results["port"]
        assert r["direct/strategy"]["groupby"] == "direct"
        assert results["jax"]["direct/strategy"]["groupby"] == "direct"
        assert "vec.GroupAggDirect" in r["direct/ops"]

    def test_both_tiers_match_interp(self, results):
        r = results["port"]
        for label in ("sorted", "direct"):
            _assert_close(r["direct/" + label], r["direct/want"], ("rf", "ls"), 1e-4, label)
        assert "vec.GroupAggDirect" in r["direct/direct_ops"]
        assert "vec.GroupAggSorted" in r["direct/sorted_ops"]

    def test_direct_composes_with_exchange(self, results):
        r = results["port"]
        _assert_close(r["direct/exchange"], r["direct/want"], ("rf", "ls"), 1e-4, "exchange")
        ops = r["direct/exchange_ops"]
        assert "mesh.ExchangeByKey" in ops
        assert "vec.GroupAggDirect" in ops
        assert "vec.GroupAggSorted" not in ops


# ---------------------------------------------------------------------------
# test_join.py::TestSpmdJoin
# ---------------------------------------------------------------------------


class TestSpmdJoin:
    def test_cost_selects_hash_on_spmd(self, results):
        assert results["port"]["join/strategy"]["join"] == "hash"
        assert results["jax"]["join/strategy"]["join"] == "hash"

    def test_both_tiers_match_interp(self, results):
        r = results["port"]
        for label in ("sorted", "hash"):
            _assert_close(r["join/" + label], r["join/want"], ("nation",), 1e-4, label)
        assert "vec.MergeJoinSorted" in r["join/sorted_ops"]
        assert "vec.HashJoinDirect" in r["join/hash_ops"]


# ---------------------------------------------------------------------------
# test_dict_encoding.py::TestSpmdStringKeys
# ---------------------------------------------------------------------------


class TestSpmdStringKeys:
    def test_forced_dict_matches_interp(self, results):
        want, got = results["port"]["dict/want"], results["port"]["dict/forced"]
        assert got["city"] == want["city"]  # decoded strings, ordered
        np.testing.assert_allclose(got["rev"], want["rev"], rtol=1e-4)
        np.testing.assert_array_equal(got["n"], want["n"])
        _assert_close(got, results["jax"]["dict/forced"], (), 2e-4, "jax")

    def test_costed_matches_interp(self, results):
        want, got = results["port"]["dict/want"], results["port"]["dict/costed"]
        assert got["city"] == want["city"]
        np.testing.assert_allclose(got["rev"], want["rev"], rtol=1e-4)
        np.testing.assert_array_equal(got["n"], want["n"])
        _assert_close(got, results["jax"]["dict/costed"], (), 2e-4, "jax")


# ---------------------------------------------------------------------------
# test_robust.py and test_compiler.py
# ---------------------------------------------------------------------------


def test_spmd_shard_fault_recovers_to_oracle(results):
    """``spmd.shard`` fires on every rank at the start of the first call,
    before any collective; every rank walks the same rung and answers."""
    r = results["port"]
    _assert_close(r["chaos/got"], r["chaos/want"], ("region",), 1e-4, "oracle")
    assert r["chaos/degraded"], r
    assert r["chaos/warned"] >= 1, r


def test_one_entry_point_all_targets_identical(results):
    r = results["port"]
    for target in ("spmd", "interp"):
        _assert_close(r["entry/" + target], r["entry/local"], ("region",), 1e-4, target)
    _assert_close(r["entry/spmd"], results["jax"]["entry/spmd"], ("region",), 2e-4, "jax")


def test_spmd_path_lowered_to_mesh_flavor(results):
    assert "mesh.MeshExecute" in results["port"]["entry/spmd_ops"]
    # the scalar pre-aggregation became a collective inside the mesh body
    assert "mesh.AllReduce" in results["port"]["entry/scalar_ops"]


@pytest.mark.parametrize("qname", ["q1", "q6"])
def test_traced_taps_count_the_whole_table(qname, results):
    """A MeshExecute's tap counts this rank's chunk; the ranks sum them at
    the end, so each reports the JAX package's whole-table counts."""
    got = results["port"]["taps/" + qname]
    assert got and got == results["jax"]["taps/" + qname]


def _sales_ctx():
    rng = np.random.default_rng(7)
    ctx = Context(pad_to=256)
    ctx.register("sales", {
        "region": rng.integers(0, 6, 2048).astype(np.int32),
        "amount": rng.gamma(2.0, 50.0, 2048).astype(np.float32),
        "year": rng.integers(2018, 2026, 2048).astype(np.int32),
    })
    return ctx


def _sales_query(ctx):
    return (ctx.table("sales").filter(col("year") >= 2020)
            .group_by("region", max_groups=8)
            .agg(sum_("amount").as_("rev"), count_().as_("n")))


def test_mesh_shortfall_fails_early():
    """A mesh-backed target without enough ranks errors at the driver,
    naming the shortfall, not inside a rendezvous."""
    ctx = _sales_ctx()
    need = world_size() * 256
    with pytest.raises(ValueError, match="device"):
        tcompile(_sales_query(ctx).program(), target="spmd", parallel=need,
                 catalog=Catalog(capacities={"sales": need * 4}), device="cpu",
                 cache=False)


def test_shortfall_raises_without_a_rendezvous():
    """With no process group, a 4-rank plan and a 4-rank mesh raise at
    once; nothing waits for ranks that never come."""
    import torch.distributed as dist

    ctx = _sales_ctx()
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="4-rank mesh"):
        ctx.compile(_sales_query(ctx), target="spmd", parallel=4, device="cpu",
                    cache=False)
    with pytest.raises(ValueError, match="device processes"):
        make_mesh((4,), ("workers",), device="cpu")
    assert time.perf_counter() - t0 < 10.0
    assert not (dist.is_available() and dist.is_initialized())
    # one rank needs no process group: the plan runs in this process
    got = ctx.execute(_sales_query(ctx), target="spmd", device="cpu")
    want = ctx.execute(_sales_query(ctx), target="interp")
    _assert_close(got, want, ("region",), 1e-4, "one rank")


def test_plan_cache_key_separates_meshes_over_other_ranks():
    """Two meshes of one shape over other ranks, on another device or over
    another backend, are two plans; the same mesh again is a hit."""
    ctx = _sales_ctx()
    cache = PlanCache()
    program = _sales_query(ctx).program()

    def plan(mesh):
        return tcompile(program, target="spmd", parallel=2, catalog=ctx.catalog(),
                        mesh=mesh, device="cpu", cache=cache)

    first = plan(_mesh((0, 1)))
    assert not first.cache_hit
    assert not plan(_mesh((2, 3))).cache_hit
    assert not plan(_mesh((0, 1), device="meta")).cache_hit
    assert not plan(_mesh((0, 1), backend="nccl")).cache_hit
    again = plan(_mesh((0, 1)))
    assert again.cache_hit and again.executable is first.executable


def test_compile_runs_the_mesh_stages_in_order():
    """``explain()`` of an spmd plan shows the lowering path's tail: the
    mesh rules, then the grouped-recombine variant."""
    ctx = _sales_ctx()
    res = tcompile(_sales_query(ctx).program(), target="spmd", parallel=4,
                   catalog=ctx.catalog(), mesh=_mesh(range(4)), device="cpu", cache=False,
                   strategy={"grouped-recombine": "exchange"})
    stages = [r.stage for r in res.records]
    assert stages[-3:] == ["lower-to-mesh", "lower-to-mesh", "grouped-exchange"]
    assert ("grouped-recombine", "exchange") in res.strategy
    assert "mesh.ExchangeByKey" in res.program.opcodes()


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_exchange_partition_matches_jax(dtype):
    """The exchange's destination of each row is JAX's: the key as uint32
    (two's complement for ints; saturated, NaN to 0, for floats) mod n,
    invalid rows dropped; each destination's rows keep their order."""
    import jax.numpy as jnp

    from repro_torch.backends.spmd import exchange_slots

    rng = np.random.default_rng(9)
    n, cap = 3, 64
    if dtype == "int32":
        key = rng.integers(-2**31, 2**31 - 1, cap, dtype=np.int64).astype(np.int32)
    else:
        key = rng.normal(0, 3e9, cap).astype(np.float32)
        key[:4] = [np.nan, -1.5, 5e9, 3.7]
    valid = rng.random(cap) < 0.8
    order, slot, keep = exchange_slots(torch.from_numpy(key), torch.from_numpy(valid), n, cap)
    dest = np.asarray(jnp.asarray(key).astype(jnp.uint32) % jnp.uint32(n)).astype(np.int64)
    dest = np.where(valid, dest, n)
    want_order = np.argsort(dest, kind="stable")
    np.testing.assert_array_equal(order.numpy(), want_order)
    kept = keep.numpy()
    np.testing.assert_array_equal(kept, dest[want_order] < n)
    np.testing.assert_array_equal(slot.numpy()[kept] // cap, dest[want_order][kept])
