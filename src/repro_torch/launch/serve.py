"""Serving launcher: batched greedy decode with a KV cache + load shedding.

The port's copy of the serve half of ``repro/launch/serve.py``.  A wave of
up to ``--batch`` requests is prefilled together, then decoded one token
per step for the whole batch.  Admission control sits in front of the
decode loop:

  * requests enter a **bounded queue** (``--queue-cap``) — arrivals beyond
    the cap are shed immediately (``serve.shed.queue_full``) instead of
    growing an unbounded backlog;
  * each request carries an optional **deadline** (``--deadline-s``); a
    request whose deadline has already passed when its wave forms is shed
    (``serve.shed.deadline``) rather than burning decode steps on an answer
    nobody is waiting for;
  * a wave that keeps failing after bounded retries sheds its requests
    (``serve.shed.error``) and the loop moves on — a poison batch cannot
    wedge the server.

The loop itself (:func:`serve_loop`) is model-free: it drives any
``run_wave(requests) -> {rid: output}`` callable; :func:`make_run_wave`
makes the model's.  It runs on the card unless ``--device cpu`` is given::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --reduced --device cpu --requests 8 --batch 4 --gen 4

The stream half (micro-batches, ``StreamConsumer``, ``stream_loop``) waits
for the stream target.
"""

from __future__ import annotations

import argparse
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..obs.trace import Tracer, get_tracer, set_tracer
from ..robust.inject import maybe_inject
from ..robust.retry import Deadline, RetryPolicy, call_with_retry

#: bounded retries for a failing decode wave before its requests are shed
WAVE_RETRY = RetryPolicy(max_retries=2, backoff_s=0.01)


@dataclass(frozen=True)
class Request:
    """One generation request: a prompt and an optional deadline."""

    rid: int
    prompt: Any
    deadline: Optional[Deadline] = None
    #: stamped by ``AdmissionQueue.offer`` — queue wait is part of the
    #: request's latency, so ``serve.request_latency_s`` measures from here,
    #: not from when the wave formed
    offered_at: Optional[float] = None


@dataclass
class ShedStats:
    """Why requests were dropped instead of served."""

    queue_full: int = 0
    deadline: int = 0
    error: int = 0

    @property
    def total(self) -> int:
        return self.queue_full + self.deadline + self.error


class AdmissionQueue:
    """Bounded FIFO with deadline-aware dequeue.

    ``offer`` rejects (sheds) when the queue is at capacity; ``take`` skips
    (sheds) requests whose deadline already passed.  Both bump the
    ``serve.shed`` counter plus a per-reason counter, so the ``--trace``
    metrics dump shows not just *that* load was shed but *why*.
    """

    def __init__(self, cap: Optional[int] = None) -> None:
        self.cap = cap
        self.shed = ShedStats()
        self._q: deque = deque()

    def __len__(self) -> int:
        return len(self._q)

    def offer(self, req: Request) -> bool:
        if self.cap is not None and len(self._q) >= self.cap:
            self.shed.queue_full += 1
            tracer = get_tracer()
            tracer.counter("serve.shed")
            tracer.counter("serve.shed.queue_full")
            return False
        if req.offered_at is None:
            req = replace(req, offered_at=time.perf_counter())
        self._q.append(req)
        return True

    def take(self, n: int) -> List[Request]:
        out: List[Request] = []
        while self._q and len(out) < n:
            req = self._q.popleft()
            if req.deadline is not None and req.deadline.expired():
                self._shed_deadline(req)
                continue
            out.append(req)
        return out

    def shed_expired(self, wave: List[Request]) -> List[Request]:
        """Drop already-expired requests from a formed wave (post-delay)."""
        keep: List[Request] = []
        for req in wave:
            if req.deadline is not None and req.deadline.expired():
                self._shed_deadline(req)
            else:
                keep.append(req)
        return keep

    def _shed_deadline(self, req: Request) -> None:
        self.shed.deadline += 1
        tracer = get_tracer()
        tracer.counter("serve.shed")
        tracer.counter("serve.shed.deadline")
        tracer.event("serve.shed.deadline", rid=req.rid)


def serve_loop(requests: Iterable[Request],
               run_wave: Callable[[List[Request]], Dict[int, Any]],
               *,
               batch: int,
               queue_cap: Optional[int] = None,
               deadline_s: Optional[float] = None,
               retry: RetryPolicy = WAVE_RETRY,
               ) -> Dict[int, Any]:
    """Admission-controlled wave loop; returns ``{rid: output}`` for the
    requests that were actually served (shed requests are absent).

    Termination is structural: every admitted request is either served,
    shed on deadline, or shed after bounded wave retries — the loop cannot
    spin on a request it will never finish.
    """
    tracer = get_tracer()
    queue = AdmissionQueue(queue_cap)
    outputs: Dict[int, Any] = {}
    for req in requests:
        if deadline_s is not None and req.deadline is None:
            req = replace(req, deadline=Deadline.after(deadline_s))
        queue.offer(req)

    while len(queue):
        wave = queue.take(batch)
        if not wave:
            continue  # everything taken was past deadline; re-check queue
        wave_t0 = time.perf_counter()
        with tracer.span("serve.wave", cat="serve", requests=len(wave),
                         batch=batch) as wave_span:
            # fault-injection point: "raise" fails the wave (retried, then
            # shed), "delay" slows it so queued deadlines expire
            def attempt() -> Dict[int, Any]:
                maybe_inject("serve.step", batch=len(wave))
                # mutate in place: a request shed on one attempt must not be
                # re-shed (re-counted) by a retry
                wave[:] = queue.shed_expired(wave)
                return run_wave(wave) if wave else {}

            try:
                got = call_with_retry(attempt, retry, name="serve.step")
            except Exception as e:
                queue.shed.error += len(wave)
                tracer.counter("serve.shed", len(wave))
                tracer.counter("serve.shed.error", len(wave))
                tracer.event("serve.wave_failed", requests=len(wave),
                             error=f"{type(e).__name__}: {e}")
                continue
            outputs.update(got)
            wave_dt = time.perf_counter() - wave_t0
            wave_span.set(served=len(got), wall_s=wave_dt)
        # per-request latency = queue wait + shared wave wall time — the
        # offer() stamp makes the p99 under load honest, not just wave time
        done = time.perf_counter()
        for r in wave:
            if r.rid in got:
                tracer.observe("serve.request_latency_s",
                               done - (r.offered_at if r.offered_at is not None
                                       else wave_t0))
        tracer.counter("serve.requests", len(got))
    return outputs


# ---------------------------------------------------------------------------
# the model's wave
# ---------------------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_run_wave(model, params, *, batch: int, prompt_len: int, gen: int, cache_cap: int,
                  device: Any) -> Callable[[List[Request]], Dict[int, np.ndarray]]:
    """``run_wave`` for :func:`serve_loop`: prefill the wave's prompts
    (padded with zero rows up to ``batch``), take the greedy token, then
    ``gen`` greedy decode steps; returns ``{rid: the gen decoded tokens}``.
    Records ``serve.prefill_s`` and ``serve.decode_step_s`` (host clock,
    the device synchronised) and counts ``serve.tokens``."""
    from ..models.api import make_serve_step

    if model.cfg.family != "dense":
        raise NotImplementedError(f"serving family {model.cfg.family!r} is not ported yet "
                                  "(ROADMAP Queue 1 item 8)")
    dev = torch.device(device)
    serve = make_serve_step(model)

    def run_wave(wave: List[Request]) -> Dict[int, np.ndarray]:
        tracer = get_tracer()
        take = len(wave)
        # waves survive shedding, so request ids need not be contiguous
        toks = np.zeros((batch, prompt_len), np.int32)
        toks[:take] = np.stack([r.prompt for r in wave]).astype(np.int32)
        out = np.zeros((batch, gen), np.int32)
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, state = model.prefill(
                params, {"tokens": torch.from_numpy(toks).to(dev)}, cache_cap)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            _sync(dev)
            tracer.observe("serve.prefill_s", time.perf_counter() - t0)
            for i in range(gen):
                t0 = time.perf_counter()
                tok, logits, state = serve(params, state, tok)
                out[:, i] = tok[:, 0].cpu().numpy()
                tracer.observe("serve.decode_step_s", time.perf_counter() - t0)
        tracer.counter("serve.tokens", take * gen)
        return {r.rid: out[j] for j, r in enumerate(wave)}

    return run_wave


def main(argv=None):
    ap = argparse.ArgumentParser()
    from ..configs import ARCH_IDS

    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-cap", type=int, default=64)
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline; requests still queued past "
                         "it are shed instead of decoded")
    ap.add_argument("--queue-cap", type=int, default=None,
                    help="bound the admission queue; arrivals beyond the "
                         "cap are shed immediately")
    ap.add_argument("--attn-mode", choices=("chunked", "pallas", "ref"), default=None,
                    help="prefill attention: the JAX default path (chunked), the "
                         "flash_attention kernel (pallas) or the plain version "
                         "(ref); default: the config's own")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--trace", nargs="?", const="trace__serve.json",
                    default=None, metavar="PATH",
                    help="enable tracing and write a Chrome trace "
                         "(chrome://tracing / Perfetto) to PATH")
    args = ap.parse_args(argv)

    from ..configs import get_config, get_reduced
    from ..models.api import build_model
    from ..relational.runtime import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[serve] {e}")

    previous_tracer = None
    if args.trace:
        previous_tracer = set_tracer(Tracer(enabled=True))
    tracer = get_tracer()

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.attn_mode is not None:
        cfg = replace(cfg, attn_mode=args.attn_mode)
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    run_wave = make_run_wave(model, params, batch=args.batch, prompt_len=args.prompt_len,
                             gen=args.gen, cache_cap=args.cache_cap, device=device)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.requests, args.prompt_len))
    requests = [Request(rid=i, prompt=prompts[i]) for i in range(args.requests)]

    t0 = time.time()
    outputs = serve_loop(requests, run_wave, batch=args.batch,
                         queue_cap=args.queue_cap,
                         deadline_s=args.deadline_s)
    dt = time.time() - t0
    total_tokens = len(outputs) * args.gen
    shed = args.requests - len(outputs)
    print(f"[serve] {len(outputs)}/{args.requests} requests × {args.gen} "
          f"tokens in {dt:.1f}s → {total_tokens/max(dt, 1e-9):.1f} tok/s "
          f"(batch={args.batch}, shed={shed}, device={device}, attn={cfg.attn_mode})")
    if args.trace:
        from ..obs.export import write_chrome_trace

        lat = tracer.histogram_summary("serve.request_latency_s") or {}
        if lat:
            print(f"[serve] request latency p50={lat['p50']:.3f}s "
                  f"p99={lat['p99']:.3f}s over {int(lat['count'])} requests")
        write_chrome_trace(args.trace, tracer)
        print(f"[serve] chrome trace → {args.trace}")
        set_tracer(previous_tracer)
    return outputs


if __name__ == "__main__":
    main()
