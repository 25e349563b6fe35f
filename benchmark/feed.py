"""The host-side feed of a training cell and the data it draws from.

``images`` is the traffic's one generator of data: uint8 images drawn
from the seed in bulk.  ``Feed`` is the trainer's producer
(``smmdax_torch.trainer.Trainer.train``): a thread assembles each
macro-step's uint8 batch through the port's ``macro_batch_at`` keyed by
the step, into a bounded queue of twice the dispatch, and the caller
stacks the dispatch's K of them; over ranks each rank's feed builds its
own block of the global batch (``block=(rank, ranks)``), as the trainer's
ranks do.  The caller's waits on the queue are the ``data.wait`` span.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np


def images(seed: int, n: int, size: int, channels: int = 3) -> np.ndarray:
    """(n, size, size, channels) uint8, uniform, from ``seed``."""
    rng = np.random.default_rng([seed, 0x1A6E5])
    return np.frombuffer(rng.bytes(n * size * size * channels), np.uint8).reshape(
        n, size, size, channels)


class Feed:
    def __init__(self, source, per_step: int, batch: int, k: int, start: int = 0,
                 block=None):
        from smmdax_torch.data.pipeline import macro_batch_at
        self.k = k
        self.q: "queue.Queue" = queue.Queue(maxsize=max(2, 2 * k))
        self.stop_event = threading.Event()
        self.next_step = start
        self.waits: List[float] = []
        # a list to keep every batch handed out in, while one is set
        self.kept: Optional[List[np.ndarray]] = None

        def produce() -> None:
            s = start
            while not self.stop_event.is_set():
                item = macro_batch_at(source, s, per_step, batch, u8=True, block=block)
                while not self.stop_event.is_set():
                    try:
                        self.q.put((s, item), timeout=0.5)
                        break
                    except queue.Full:
                        continue
                s += 1

        self.thread = threading.Thread(target=produce, daemon=True)
        self.thread.start()

    def dispatch_batch(self, record: bool = True, k: int = 0) -> np.ndarray:
        """The next K macro-steps' (K, per_step, B, H, W, C) stack (``k``
        of them when given; one macro-step's batch alone when that is 1)."""
        k = k or self.k
        t0 = time.perf_counter()
        parts = []
        for _ in range(k):
            s, item = self.q.get(timeout=600)
            if s != self.next_step:
                raise RuntimeError(f"batch of step {s} where {self.next_step} was due")
            self.next_step += 1
            parts.append(item)
        if record:
            self.waits.append(time.perf_counter() - t0)
        out = parts[0] if k == 1 else np.stack(parts)
        if self.kept is not None:
            self.kept.append(out)
        return out

    def close(self) -> None:
        self.stop_event.set()
        self.thread.join()
