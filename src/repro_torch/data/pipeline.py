"""Host-side data pipeline with background prefetch.

Counterpart of :mod:`repro.data.pipeline`: the paper's first optimization
opportunity, *overlapping I/O with computing* (§IV-C, tasks T36–T43 of
Fig. 1).  A producer thread fetches the next mini-batches and stages them
onto the device while the current step computes.  The loader sums over
its batches ``t_io`` (the fetch) and ``t_h2d`` (the host-to-device copy,
timed to its completion, the reference's ``block_until_ready``), so that
its memory does not grow with the run; under
:func:`repro_torch.tracing.record` the consumer's wait for each batch is
the counter ``loader.wait``.

On CUDA a batch is staged by ``pin_memory()`` and a non-blocking copy on
the loader's own stream; the consumer's stream waits on that copy's event
before it reads the batch, and the tensors are recorded on the consumer's
stream, so the allocator never hands their memory out while a step still
reads it.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import resolve_device


@dataclass
class SyntheticLMDataset:
    """Deterministic synthetic token stream (documents of random tokens
    with next-token labels); the reference's generator, so the same seed
    gives the same int32 batches."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    simulate_io_seconds: float = 0.0    # inject disk latency (experiments)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        while True:
            if self.simulate_io_seconds:
                time.sleep(self.simulate_io_seconds)
            tokens = rng.integers(0, self.vocab_size,
                                  (self.batch_size, self.seq_len + 1),
                                  dtype=np.int32)
            yield {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


class PrefetchLoader:
    """Producer-consumer loader with ``depth`` staged batches on ``device``
    (default CUDA, which raises without a GPU).

    ``depth=0`` disables prefetching (the naive S-SGD of Eq. (2): the
    fetch blocks the step).  Batches come out as dicts of torch tensors
    (int32, as the dataset's arrays).  Call :meth:`close` when done.
    """

    def __init__(self, dataset, depth: int = 2, device=None):
        self.dataset = iter(dataset)
        self.depth = depth
        self.device = resolve_device(device)
        # (batches, t_io, t_h2d) sums, swapped whole by the one thread that fetches
        self._sums = (0, 0.0, 0.0)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if depth > 0:
            self._thread = threading.Thread(target=self._producer, daemon=True)
            self._thread.start()

    def _stage(self, batch: dict) -> tuple[dict, torch.cuda.Event | None]:
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if self._stream is None:
            return host, None
        with torch.cuda.stream(self._stream):
            staged = {k: t.pin_memory().to(self.device, non_blocking=True)
                      for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        done.synchronize()
        return staged, done

    def _fetch_and_stage(self):
        t0 = time.perf_counter()
        batch = next(self.dataset)
        t1 = time.perf_counter()
        staged = self._stage(batch)
        t2 = time.perf_counter()
        n, io, h2d = self._sums
        self._sums = (n + 1, io + (t1 - t0), h2d + (t2 - t1))
        return staged

    def _producer(self):
        while not self._stop.is_set():
            try:
                item = self._fetch_and_stage()
            except StopIteration:
                self._q.put(None)
                return
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        with tracing.timed("loader.wait"):
            item = self._fetch_and_stage() if self.depth == 0 else self._q.get()
        if item is None:
            raise StopIteration
        batch, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in batch.values():
                t.record_stream(consumer)
        return batch

    def close(self):
        """Stop the producer and wait for it: drain the queue until the
        thread has left its loop."""
        self._stop.set()
        while self._thread is not None and self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)

    @property
    def batches(self) -> int:
        """Batches fetched so far."""
        return self._sums[0]

    def mean_t_io(self) -> float:
        n, io, _ = self._sums
        return io / n if n else 0.0

    def mean_t_h2d(self) -> float:
        n, _, h2d = self._sums
        return h2d / n if n else 0.0
