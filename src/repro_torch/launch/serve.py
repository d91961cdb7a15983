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

The stream half grows the same loop into a stream consumer: sequenced
micro-batches (:class:`MicroBatch`) from the host fold into a ``target="stream"``
plan's state on the card (:class:`StreamConsumer`), with snapshots through
:class:`~repro_torch.distributed.checkpoint.CheckpointManager` and
exactly-once recovery, backpressure and watermark shedding in
:func:`stream_loop`.
"""

from __future__ import annotations

import argparse
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..errors import is_card_fault
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
# streaming: checkpointed incremental consumption of micro-batches
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MicroBatch:
    """One sequenced micro-batch of stream rows.

    ``seq`` is the monotone sequence number the exactly-once protocol keys
    on; ``rows`` are column arrays on the host (≤ the plan's batch
    capacity, physical dtypes); ``watermark`` is the batch's event-time
    high watermark (any monotone-ish clock), consulted by
    ``stream_loop``'s lag shedding.
    """

    seq: int
    rows: Any                      # Mapping[str, np.ndarray]
    watermark: Optional[float] = None

    @property
    def n_rows(self) -> int:
        cols = dict(self.rows)
        return len(next(iter(cols.values()))) if cols else 0


def microbatches(rows: Any, batch_rows: int, *, watermark_col: Optional[str] = None,
                 start_seq: int = 0) -> List[MicroBatch]:
    """Chop full columns into sequenced micro-batches (tests + benchmarks)."""
    cols = {k: np.asarray(v) for k, v in dict(rows).items()}
    n = len(next(iter(cols.values()))) if cols else 0
    out: List[MicroBatch] = []
    for i, lo in enumerate(range(0, n, batch_rows)):
        chunk = {k: v[lo:lo + batch_rows] for k, v in cols.items()}
        wm = (float(np.max(chunk[watermark_col]))
              if watermark_col and len(chunk[watermark_col]) else None)
        out.append(MicroBatch(seq=start_seq + i, rows=chunk, watermark=wm))
    return out


@dataclass
class StreamStats:
    """What the consumer did — and what it refused to do twice."""

    batches: int = 0          # micro-batches folded into the state
    rows: int = 0             # stream rows folded
    deduped: int = 0          # re-delivered batches skipped by seq number
    snapshots: int = 0
    restores: int = 0
    replayed: int = 0         # batches re-fed after a restore
    failures: int = 0         # process() attempts that raised
    shed_watermark: int = 0   # batches dropped by lag shedding
    paused: int = 0           # intake pauses from backpressure


class StreamConsumer:
    """Drives a stream-target executable over sequenced micro-batches with
    checkpointed exactly-once recovery.

    The carried state is a pure fold: ``state_after(k)`` depends only on
    the set of folded sequence numbers ≤ k.  Exactly-once therefore needs
    (1) **atomic commit** — ``process`` assigns ``self.state`` and
    ``self.committed_seq`` only after the (functional) step succeeds, so a
    mid-batch crash never leaves a half-folded batch; (2) **durable
    snapshots** — every ``snapshot_every`` folded batches the state tree
    goes through :class:`~repro_torch.distributed.checkpoint.CheckpointManager`
    (atomic tmp→rename) with the committed sequence number and watermark in
    the manifest's ``extra``; (3) **dedup on replay** — ``process`` is a
    counted no-op for ``seq ≤ committed_seq``, so re-delivering the suffix
    after :meth:`restore` can never double-count a batch.

    The state stays on the executable's device between batches; a
    snapshot copies it to the host.  A fault of the card or of a kernel
    (:func:`repro_torch.errors.is_card_fault`) propagates out of
    ``process`` and ``restore`` untouched, and ``stream_loop`` does not
    recover from it: a CUDA error poisons the context, so a replay on it
    cannot succeed.

    The three ``stream.*`` fault-injection points bracket exactly these
    transitions, which is what the chaos suite kills.
    """

    def __init__(self, compiled: Any, sources: Any, *,
                 checkpoint: Any = None, snapshot_every: int = 8,
                 strict_restore: bool = False) -> None:
        # accept a driver CompileResult or a bare StreamExecutable
        ex = getattr(compiled, "executable", compiled)
        if not hasattr(ex, "init_state"):
            raise TypeError(
                f"StreamConsumer needs a stream-target executable "
                f"(compile(..., target='stream')), got {type(ex).__name__}")
        self.exec = ex
        self.exec.bind(dict(sources))
        self.ckpt = checkpoint
        self.snapshot_every = int(snapshot_every)
        self.strict_restore = strict_restore
        self.stats = StreamStats()
        self.state = self.exec.init_state()
        #: highest sequence number folded into the in-memory state
        self.committed_seq = -1
        #: highest sequence number covered by a durable snapshot
        self.snapshot_seq = -1
        self.watermark: Optional[float] = None

    def inflight(self) -> int:
        """Batches folded but not yet durable — the in-flight window."""
        return self.committed_seq - self.snapshot_seq

    def process(self, batch: MicroBatch) -> bool:
        """Fold one micro-batch; returns False for a deduped redelivery."""
        tracer = get_tracer()
        if batch.seq <= self.committed_seq:
            self.stats.deduped += 1
            tracer.counter("stream.deduped")
            return False
        t0 = time.perf_counter()
        with tracer.span("stream.batch", cat="stream", seq=batch.seq,
                         rows=batch.n_rows):
            # the mid-batch kill: fires before the fold commits, so the
            # batch stays uncommitted and must be re-delivered
            maybe_inject("stream.batch", seq=batch.seq)
            state = self.exec.step(self.state, batch.rows)
            # -- commit point: all-or-nothing from here down ---------------
            self.state = state
            self.committed_seq = batch.seq
            if batch.watermark is not None:
                self.watermark = (batch.watermark if self.watermark is None
                                  else max(self.watermark, batch.watermark))
        self.stats.batches += 1
        self.stats.rows += batch.n_rows
        tracer.counter("stream.batches")
        tracer.counter("stream.rows", batch.n_rows)
        tracer.observe("stream.batch_s", time.perf_counter() - t0)
        tracer.observe("stream.lag_batches", float(self.inflight()))
        if self.inflight() >= self.snapshot_every:
            self.snapshot()
        return True

    def snapshot(self) -> Optional[int]:
        """Publish the state atomically; returns the covered seq (or None)."""
        if self.committed_seq < 0 or self.committed_seq == self.snapshot_seq:
            return None
        tracer = get_tracer()
        t0 = time.perf_counter()
        with tracer.span("stream.snapshot", cat="stream",
                         seq=self.committed_seq):
            # the mid-snapshot kill: fires before the save, and the
            # CheckpointManager's tmp→rename publish means a kill *during*
            # the save leaves the previous snapshot intact either way
            maybe_inject("stream.snapshot", seq=self.committed_seq)
            if self.ckpt is not None:
                self.ckpt.save(self.committed_seq,
                               self.exec.state_to_tree(self.state),
                               extra={"seq": self.committed_seq,
                                      "watermark": self.watermark,
                                      "program": self.exec.program.name})
        self.snapshot_seq = self.committed_seq
        self.stats.snapshots += 1
        tracer.counter("stream.snapshots")
        tracer.observe("stream.snapshot_s", time.perf_counter() - t0)
        return self.snapshot_seq

    def restore(self) -> int:
        """Roll back to the last durable snapshot (or the initial state).

        Returns the restored sequence number; the caller owns re-delivering
        every batch with a higher seq (``process`` dedups the rest).
        """
        tracer = get_tracer()
        with tracer.span("stream.restore", cat="stream"):
            maybe_inject("stream.restore", seq=self.snapshot_seq)
            if self.ckpt is not None and self.ckpt.latest_step() is not None:
                tree, extra = self.ckpt.restore(
                    self.exec.state_to_tree(self.exec.init_state()),
                    strict=self.strict_restore)
                self.state = self.exec.state_from_tree(tree)
                self.committed_seq = int(extra.get("seq", -1))
                wm = extra.get("watermark")
                self.watermark = None if wm is None else float(wm)
            else:
                self.state = self.exec.init_state()
                self.committed_seq = -1
                self.watermark = None
        self.snapshot_seq = self.committed_seq
        self.stats.restores += 1
        tracer.counter("stream.restores")
        return self.committed_seq

    def results(self) -> List[Any]:
        """Finalize the current state (decode, avg arithmetic, order/limit)."""
        return self.exec.finalize(self.state)


def stream_loop(batches: Iterable[MicroBatch], consumer: StreamConsumer, *,
                queue_cap: Optional[int] = None,
                inflight_cap: Optional[int] = None,
                max_lag_s: Optional[float] = None,
                max_recoveries: int = 3) -> List[Any]:
    """`serve_loop` grown into a continuously-running stream consumer.

    Per arriving micro-batch: admission through the same bounded
    :class:`AdmissionQueue`, **backpressure** (when the consumer's
    un-snapshotted window reaches ``inflight_cap``, intake pauses and a
    snapshot drains the window — bounded lag by construction), **watermark
    shedding** (a batch whose event-time watermark lags the consumer's by
    more than ``max_lag_s`` is shed, counted, and never folded), and
    **crash recovery** (a failed fold restores the last snapshot and
    replays the retained uncommitted suffix; dedup-by-seq makes the replay
    idempotent).  Recovery is bounded by ``max_recoveries``; exhaustion
    re-raises — a permanently poisoned stream must not spin forever.  A
    fault of the card or of a kernel re-raises at once, with no restore
    walked (counted as ``stream.card_fault``).

    Returns ``consumer.results()`` — the finalized query answer over every
    batch folded exactly once.
    """
    tracer = get_tracer()
    queue = AdmissionQueue(queue_cap)
    #: delivered but not yet snapshot-durable — the replay suffix.  In a
    #: real deployment this is the upstream log's unacknowledged tail; the
    #: loop retains it so recovery needs nothing beyond the last snapshot.
    pending: Dict[int, MicroBatch] = {}
    recoveries = 0
    source = iter(batches)
    intake_open = True

    def recover(error: BaseException) -> None:
        nonlocal recoveries
        t0 = time.perf_counter()
        while True:
            consumer.stats.failures += 1
            tracer.counter("stream.failures")
            if is_card_fault(error):
                tracer.counter("stream.card_fault")
                raise error
            if recoveries >= max_recoveries:
                raise error
            recoveries += 1
            try:
                restored = consumer.restore()
                for seq in sorted(pending):
                    if consumer.process(pending[seq]):
                        consumer.stats.replayed += 1
                        tracer.counter("stream.replayed")
            except Exception as e:
                # a recovery that itself fails (stream.restore injection, or
                # the armed fault firing again mid-replay) — go around,
                # bounded by max_recoveries
                error = e
                continue
            tracer.event("stream.recovered", restored_seq=restored,
                         replayed=len([s for s in pending if s > restored]))
            tracer.observe("stream.recovery_s", time.perf_counter() - t0)
            return

    while True:
        if intake_open:
            if (inflight_cap is not None
                    and consumer.inflight() >= inflight_cap):
                # backpressure: pause intake, drain the window durably
                consumer.stats.paused += 1
                tracer.counter("stream.backpressure.paused")
                try:
                    consumer.snapshot()
                except Exception as e:
                    recover(e)
                continue
            try:
                nb = next(source)
            except StopIteration:
                intake_open = False
            else:
                queue.offer(Request(rid=nb.seq, prompt=nb))
        wave = queue.take(1)
        if not wave:
            if not intake_open:
                break
            continue
        mb: MicroBatch = wave[0].prompt
        if (max_lag_s is not None and mb.watermark is not None
                and consumer.watermark is not None
                and mb.watermark < consumer.watermark - max_lag_s):
            consumer.stats.shed_watermark += 1
            tracer.counter("stream.shed.watermark")
            tracer.event("stream.shed.watermark", seq=mb.seq,
                         watermark=mb.watermark, high=consumer.watermark)
            continue
        pending[mb.seq] = mb
        try:
            consumer.process(mb)
        except Exception as e:
            recover(e)
        if wave[0].offered_at is not None:
            # intake-to-fold latency, the streaming sibling of the serve
            # loop's queue-wait-inclusive request latency
            tracer.observe("stream.queue_wait_s",
                           time.perf_counter() - wave[0].offered_at)
        for seq in [s for s in pending if s <= consumer.snapshot_seq]:
            del pending[seq]
    try:
        consumer.snapshot()   # final barrier: everything folded is durable
    except Exception as e:
        recover(e)
        consumer.snapshot()
    return consumer.results()


# ---------------------------------------------------------------------------
# the model's wave
# ---------------------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_run_wave(model, params, *, batch: int, prompt_len: int, gen: int, cache_cap: int,
                  device: Any) -> Callable[[List[Request]], Dict[int, np.ndarray]]:
    """``run_wave`` for :func:`serve_loop`, with the JAX launcher's family
    branches: the dense and MoE families prefill the wave's prompts (padded
    with zero rows up to ``batch``) and take the greedy token; the VLM
    family, as JAX's ``else`` branch, starts from ``init_state``'s empty
    cache with a zero token and no prefill (its prompts are not read: a
    kept quirk, ROADMAP Queue 3).  Then ``gen`` greedy decode steps;
    returns ``{rid: the gen decoded tokens}``.  Records ``serve.prefill_s``
    (where there is a prefill) and ``serve.decode_step_s`` (host clock,
    the device synchronised) and counts ``serve.tokens``."""
    from ..models.api import make_serve_step

    family = model.cfg.family
    if family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(f"serving family {family!r} is not ported yet "
                                  "(ROADMAP Queue 1 items 8.4-8.6)")
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
            if family == "vlm":
                state = model.init_state(batch, cache_cap, dev)
                tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
            else:
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

    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b",
                    help="a dense, MoE or VLM config (the VLM decodes from an empty "
                         "cache, as JAX's launcher does)")
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
