"""Token data pipeline (the port's copy of ``repro/data/pipeline.py``,
verbatim: numpy only, so ``batch_at(step)`` gives the JAX package's
batches bit for bit).

Determinism contract (what survives restarts and elastic resize):
  * the batch for global step ``t`` is a pure function of (seed, t) —
    NOT of any iterator state — so restart-from-checkpoint resumes exactly;
  * host-sharding: each host materializes only its slice
    ``[host_id::n_hosts]`` of the global batch, so the same stream works at
    any host count (elastic rescale just changes the slicing);
  * a tiny background prefetch thread keeps ``depth`` batches ready.

The generator synthesizes a mixture of repeated n-grams (so models have
something learnable) over a configurable vocab.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    ngram: int = 8

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The (host slice of the) batch for global step ``step``."""
        rng = np.random.default_rng((self.seed, step))
        b = self.global_batch
        # learnable structure: each row repeats a small set of n-grams
        base = rng.integers(0, self.vocab, (b, self.ngram), dtype=np.int32)
        reps = -(-(self.seq_len + 1) // self.ngram)
        toks = np.tile(base, (1, reps))[:, : self.seq_len + 1]
        noise = rng.random((b, self.seq_len + 1)) < 0.05
        toks = np.where(noise, rng.integers(0, self.vocab, toks.shape), toks)
        sl = slice(self.host_id, None, self.n_hosts)
        return {
            "tokens": toks[sl, :-1].astype(np.int32),
            "labels": toks[sl, 1:].astype(np.int32),
            "mask": np.ones((toks[sl].shape[0], self.seq_len), np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def prefetching(self, start_step: int = 0, depth: int = 2):
        """Iterator with a background prefetch thread, resumable at a step."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def producer():
            s = start_step
            while not stop.is_set():
                q.put((s, self.batch_at(s)))
                s += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()

        class _Iter:
            def __iter__(self):
                return self

            def __next__(self):
                return q.get()

            def close(self):
                stop.set()
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass

        return _Iter()
