"""The port's serve loop: admission, shedding and retries (the model-free
cases of ``tests/test_robust.py::TestServeShedding``, on the port's
``serve_loop``, fault injection and tracer), the serve CLI on the CPU, and
the serve step's argmax over a vocabulary split across four gloo ranks
(ties across the slices take the lowest index, as ``jnp.argmax``).
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.serve import AdmissionQueue, Request, serve_loop  # noqa: E402
from repro_torch.obs.trace import tracing  # noqa: E402
from repro_torch.robust import (  # noqa: E402
    Deadline, InjectedFault, RetryPolicy, call_with_retry, clear_faults, inject,
    maybe_inject, registered_points)

ROOT = Path(__file__).resolve().parents[1]
CHAOS_SEED = int(os.environ.get("REPRO_CHAOS_SEED", "0"))


@pytest.fixture(autouse=True)
def _no_armed_faults():
    clear_faults()
    yield
    clear_faults()


def _echo_wave(wave):
    return {r.rid: r.prompt for r in wave}


class TestServeShedding:
    def test_no_faults_serves_everything(self):
        reqs = [Request(rid=i, prompt=i) for i in range(10)]
        out = serve_loop(reqs, _echo_wave, batch=4)
        assert out == {i: i for i in range(10)}

    def test_queue_cap_sheds_overflow(self):
        with tracing() as tr:
            reqs = [Request(rid=i, prompt=i) for i in range(10)]
            out = serve_loop(reqs, _echo_wave, batch=4, queue_cap=6)
        assert len(out) == 6
        assert tr.counters.get("serve.shed.queue_full", 0) == 4
        assert tr.counters.get("serve.shed", 0) == 4

    def test_slow_step_sheds_deadlines_without_deadlock(self):
        reqs = [Request(rid=i, prompt=i) for i in range(12)]

        def slow_wave(wave):
            time.sleep(0.01)
            return _echo_wave(wave)

        t0 = time.monotonic()
        with tracing() as tr:
            with inject("serve.step", mode="delay", delay_s=0.05,
                        times=None, seed=CHAOS_SEED):
                out = serve_loop(reqs, slow_wave, batch=4, deadline_s=0.08)
        wall = time.monotonic() - t0
        assert wall < 5.0, "shedding must terminate promptly"
        shed = 12 - len(out)
        assert shed > 0, "a saturated server must shed"
        assert tr.counters.get("serve.shed.deadline", 0) == shed
        # every request is accounted for: served or shed, never lost
        assert len(out) + shed == 12

    def test_failing_wave_sheds_after_bounded_retries(self):
        reqs = [Request(rid=i, prompt=i) for i in range(8)]
        with tracing() as tr:
            with inject("serve.step", mode="raise", times=None,
                        seed=CHAOS_SEED):
                out = serve_loop(reqs, _echo_wave, batch=4)
        assert out == {}
        assert tr.counters.get("serve.shed.error", 0) == 8
        assert tr.counters.get("robust.retry.serve.step", 0) >= 2

    def test_transient_wave_failure_is_retried_not_shed(self):
        reqs = [Request(rid=i, prompt=i) for i in range(4)]
        with inject("serve.step", mode="raise", times=1, seed=CHAOS_SEED):
            out = serve_loop(reqs, _echo_wave, batch=4)
        assert len(out) == 4

    def test_take_skips_expired(self):
        q = AdmissionQueue()
        q.offer(Request(rid=0, prompt=0, deadline=Deadline(at=-1.0)))
        q.offer(Request(rid=1, prompt=1))
        wave = q.take(4)
        assert [r.rid for r in wave] == [1]
        assert q.shed.deadline == 1


def test_request_latency_is_observed_per_served_request():
    with tracing() as tr:
        serve_loop([Request(rid=i, prompt=i) for i in range(6)], _echo_wave, batch=4)
    lat = tr.histogram_summary("serve.request_latency_s")
    assert lat["count"] == 6 and 0 <= lat["p50"] <= lat["p99"]
    assert tr.counters["serve.requests"] == 6
    assert [s.name for s in tr.spans] == ["serve.wave", "serve.wave"]


def test_only_the_serve_step_point_is_registered():
    """The serve step, the compile driver's five points, the stream
    consumer's three and the spmd backend's one are wired, as in the JAX
    package."""
    points = {name: p.modes for name, p in registered_points().items()}
    assert points == {"serve.step": ("raise", "delay"),
                      "spmd.shard": ("raise", "delay"),
                      "stream.batch": ("raise", "delay"),
                      "stream.snapshot": ("raise", "delay"),
                      "stream.restore": ("raise", "delay"),
                      "driver.pass": ("raise", "corrupt", "delay"),
                      "store.load": ("raise", "corrupt", "delay"),
                      "store.save": ("raise", "delay"),
                      "backend.compile": ("raise", "delay"),
                      "backend.execute": ("raise", "delay")}
    with pytest.raises(KeyError):
        with inject("pjit.step"):
            pass
    with pytest.raises(ValueError):
        with inject("serve.step", mode="corrupt"):
            pass
    with inject("serve.step", mode="raise", times=1):
        with pytest.raises(InjectedFault):
            maybe_inject("serve.step")
        assert maybe_inject("serve.step", payload=3) == 3  # fired once only


def test_retry_policy_and_deadline():
    p = RetryPolicy(backoff_s=0.1, backoff_factor=2.0, max_backoff_s=0.3)
    assert p.backoff(0) == pytest.approx(0.1) and p.backoff(5) == pytest.approx(0.3)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    assert call_with_retry(flaky, RetryPolicy(max_retries=2), sleep=lambda s: None) == "ok"
    assert len(calls) == 3
    calls.clear()

    def wrong_kind():
        calls.append(1)
        raise KeyError("not retried")

    with pytest.raises(KeyError):  # not in retry_on: raised on the first call
        call_with_retry(wrong_kind, RetryPolicy(max_retries=3, retry_on=(RuntimeError,)))
    assert len(calls) == 1
    d = Deadline.after(100.0, clock=lambda: 0.0)
    assert d.remaining(clock=lambda: 40.0) == pytest.approx(60.0)
    assert not d.expired(clock=lambda: 99.0) and d.expired(clock=lambda: 100.0)


def _serve_cli(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)


def test_serve_cli_on_the_cpu(tmp_path):
    trace = tmp_path / "serve.json"
    out = _serve_cli("--arch", "qwen2-1.5b", "--reduced", "--device", "cpu", "--requests", "8",
                     "--batch", "4", "--gen", "4", "--attn-mode", "pallas",
                     "--trace", str(trace))
    assert out.returncode == 0, out.stderr
    assert "[serve] 8/8 requests × 4 tokens" in out.stdout
    assert "attn=pallas" in out.stdout and "p50=" in out.stdout
    assert trace.exists()


def test_serve_cli_refuses_without_a_card():
    """No ``--device``: the card, and with none visible (the child sees
    none) the CLI exits non-zero instead of serving on the CPU."""
    out = _serve_cli("--reduced", "--requests", "2", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "none is visible" in out.stderr
    assert "requests ×" not in out.stdout


ARGMAX_SCRIPT = '''
import datetime, os, pickle
import torch, torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

dist.init_process_group("gloo", init_method="file://" + os.environ["INIT_FILE"],
                        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import sharding as shd
from repro_torch.models.api import build_model, make_serve_step

work = os.environ["WORK"]
with open(os.path.join(work, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
dm = shd.device_mesh(mesh)
out = {}
# the function alone: the vocabulary split over model, the rows over data
logits = torch.from_numpy(inp["logits"])
for name, pl in (("rows replicated", [Replicate(), Shard(1)]),
                 ("rows split", [Shard(0), Shard(1)]),
                 ("vocab over both", [Shard(1), Shard(1)])):
    x = distribute_tensor(logits, dm, pl, src_data_rank=None)
    with shd.comm_bytes() as comm:
        got = shd.vocab_parallel_argmax(x)
    out[name] = (got.full_tensor().numpy(), [str(p) for p in got.placements], comm.by_kind())
# a batch-1 serve step on the (2, 2) mesh: tokens and state placed as the
# dry-run places them (batch 1 does not divide over data)
model = build_model(get_reduced("qwen2-1.5b"))
params = params_from_jax(inp["params"], "cpu")
state = model.init_state(1, 8)
tokens = torch.from_numpy(inp["tokens"])
placed = shd.shard_tree(params, shd.tree_param_specs(params, mesh), dm)
st = shd.shard_tree(state, shd.cache_specs(state, mesh, model.cfg), dm)
tok = shd.shard_tree({"tokens": tokens}, shd.batch_specs({"tokens": (tokens.shape, tokens.dtype)},
                                                        mesh), dm)["tokens"]
with shd.dtensor_scope(placed), shd.comm_bytes() as comm:
    nxt, lg, _ = make_serve_step(model)(placed, st, tok)
out["serve"] = (nxt.full_tensor().numpy(), lg.full_tensor().numpy(),
                [str(p) for p in lg.placements], comm.records)
with open(os.path.join(work, f"rank{dist.get_rank()}.pkl"), "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def vocab_split_argmax(tmp_path_factory):
    """Four gloo ranks on a (data 2, model 2) mesh: ``vocab_parallel_argmax``
    on logits with ties across the vocabulary's slices, and a batch-1 serve
    step of the reduced Qwen2 (vocab 512, 256 a model rank) whose final
    norm and embedding make two tokens in different slices tie for the
    max; beside them JAX's ``make_serve_step`` on the same weights."""
    import pickle

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_reduced as jax_reduced
    from repro.models.api import build_model as jax_build
    from repro.models.api import make_serve_step as jax_serve_step
    from repro_torch.launch.hermetic import run_ranks

    work = tmp_path_factory.mktemp("argmax_ranks")
    logits = np.zeros((4, 512), np.float32)
    logits[0, [10, 300]] = 3.0       # a tie across the model ranks' slices
    logits[1, [300, 301, 511]] = 2.0  # within the upper slice
    logits[2, [255, 256]] = 1.0       # at the slices' border
    logits[3] = -1.0                  # all equal: index 0
    jcfg = jax_reduced("qwen2-1.5b")
    params = jax.device_get(jax_build(jcfg).init(jax.random.PRNGKey(1)))
    j = 7                             # the final hidden state is x_j e_j; rows 10 and
    params["final_norm"] = np.zeros_like(params["final_norm"])  # 300 give it its max
    params["final_norm"][j] = 1.0     # if x_j > 0, rows 20 and 400 if x_j < 0
    emb = np.array(params["emb"])
    emb[:, j] = 0.0
    emb[[10, 300], j] = 5.0
    emb[[20, 400], j] = -5.0
    params["emb"] = emb
    tokens = np.array([[123]], np.int32)
    jmodel = jax_build(jcfg)
    jnext, jlogits, _ = jax_serve_step(jmodel)(params, jmodel.init_state(1, 8), jnp.asarray(tokens))
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"logits": logits, "params": params, "tokens": tokens}, f)
    ranks = run_ranks(ARGMAX_SCRIPT, 4, work, ROOT, timeout=240, WORK=str(work))
    for r, (rc, _, err) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-4000:]}"
    return {"ranks": [pickle.loads((work / f"rank{r}.pkl").read_bytes()) for r in range(4)],
            "logits": logits, "jax_argmax": np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1)),
            "jax_next": np.asarray(jnext), "jax_logits": np.asarray(jlogits)}


@pytest.mark.parametrize("placement", ["rows replicated", "rows split", "vocab over both"])
def test_vocab_parallel_argmax_takes_the_lowest_index_among_ties(vocab_split_argmax, placement):
    import numpy as np

    want = vocab_split_argmax["jax_argmax"]
    assert list(want) == [10, 300, 255, 0]
    for out in vocab_split_argmax["ranks"]:
        got, pl, kinds = out[placement]
        np.testing.assert_array_equal(got, want)
        assert "S(1)" not in pl               # the answer is whole over the vocabulary
        assert set(kinds) == {"all_gather_into_tensor"}  # (value, index) pairs, not logits


def test_batch_one_serve_step_on_a_vocab_split_mesh_gives_jaxs_token(vocab_split_argmax):
    import numpy as np

    want = vocab_split_argmax["jax_next"]
    assert int(want[0, 0]) in (10, 20)       # JAX's first of two tied maxima
    for out in vocab_split_argmax["ranks"]:
        nxt, logits, pl, records = out["serve"]
        np.testing.assert_array_equal(nxt, want)
        assert logits[0, 10] == logits[0, 300] and logits[0, 20] == logits[0, 400]
        assert "S(1)" in pl                   # the logits stay split over the vocabulary
        gathered = [r for r in records if r["kind"] == "all_gather_into_tensor"
                    and r["shape"][-1:] in ((512,), (256,))]
        assert not gathered, gathered
        np.testing.assert_allclose(logits, vocab_split_argmax["jax_logits"], rtol=1e-5,
                                   atol=1e-5)
