"""The port's serve loop: admission, shedding and retries (the model-free
cases of ``tests/test_robust.py::TestServeShedding``, on the port's
``serve_loop``, fault injection and tracer), and the serve CLI on the CPU.
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
