"""Training input pipeline: host decode thread + on-device preprocessing.

Port of ``givepose_tpu/data/pipeline.py``.  Replaces the reference's
multiprocess DataLoader (engine/train.py:111-113, num_workers=4) with a
single prefetch thread: the heavy work (crop/zoom/augment) runs on the
device (``data.preprocess``), so the host only decodes PNGs and stacks
arrays; one thread double-buffers ahead of the device.  The same seeds
give the same host batches as the JAX package's pipeline.
"""

from __future__ import annotations

import queue
import random
import threading
import time

import numpy as np

from givepose_torch.core.mesh import process_local_indices
from givepose_torch.data.preprocess import collate_records
from givepose_torch.data.records import NocsRecordReader
from givepose_torch.data.sampler import EpochSampler


class TrainPipeline:
    """``batch_size`` is the GLOBAL batch; with ``num_processes`` > 1 each
    feeder process reads only its chunk of every global batch (the sampler
    is seed-deterministic, so all processes agree on the epoch order) and
    yields local batches of ``batch_size // num_processes``.

    ``read_seconds`` holds the host time each batch took to read and
    collate, in the order they were read."""

    def __init__(self, reader: NocsRecordReader, batch_size: int,
                 train_size: int, syn_ratio: float = 3.0, seed: int = 0,
                 prefetch: int = 2, process_id: int = 0,
                 num_processes: int = 1):
        self.reader = reader
        self.batch_size = batch_size
        assert batch_size % num_processes == 0, (batch_size, num_processes)
        self.process_id = process_id
        self.num_processes = num_processes
        self.local_batch = batch_size // num_processes
        subset = reader.subset_len
        if len(subset) == 2:
            cam_len, real_len = subset
        elif reader.source == "CAMERA":
            cam_len, real_len = len(reader), 0
        else:
            cam_len, real_len = 0, len(reader)
        self.sampler = EpochSampler(cam_len, real_len, train_size,
                                    syn_ratio, seed)
        self.seed = seed
        self._epoch = 0
        self.prefetch = prefetch
        self.read_seconds: list[float] = []

    def skip_epochs(self, n: int) -> None:
        """Fast-forward n epochs of host randomness for exact resume:
        replays the sampler's epoch draws AND advances the per-epoch
        read-rng counter.  The instance-selection rng is derived per
        (seed, epoch, batch) — a flat counter-based stream — because the
        stream-consumption count of a stateful rng is data-dependent
        (bad-sample retries, ban_mug redraws) and therefore not
        replayable without re-reading every file."""
        for _ in range(n):
            self.sampler.epoch_indices()
            self._epoch += 1

    def _read_batch(self, indices, rng) -> dict:
        t0 = time.perf_counter()
        records = []
        for idx in indices:
            rec = None
            probe = int(idx)
            for _ in range(32):       # bad-sample skipping (reference
                rec = self.reader.read(probe, rng)       # :185-255)
                if rec is not None:
                    break
                probe = (probe + 1) % len(self.reader)
            if rec is None:
                raise RuntimeError("could not read any valid sample")
            records.append(rec)
        batch = collate_records(records)
        self.read_seconds.append(time.perf_counter() - t0)
        return batch

    def epoch(self):
        """Yield raw host batches for one epoch (prefetched)."""
        indices = self.sampler.epoch_indices()
        epoch_no = self._epoch
        self._epoch += 1
        if self.num_processes > 1:
            indices = process_local_indices(
                indices, self.batch_size, process_id=self.process_id,
                num_processes=self.num_processes)
        bs = self.local_batch
        n_batches = len(indices) // bs
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)

        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up when the consumer is gone —
            an abandoned generator (e.g. next(iter(epoch()))) must not
            leave the worker blocked on a full queue forever, pinning
            `prefetch` host batches of RAM for the process lifetime."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in range(n_batches):
                    chunk = indices[b * bs:(b + 1) * bs]
                    # str seeding hashes deterministically (sha512); a
                    # tuple seed raises TypeError on Python >= 3.11
                    rng = random.Random(f"{self.seed}:{epoch_no}:{b}")
                    if not put(self._read_batch(chunk, rng)):
                        return
                put(None)
            except BaseException as e:  # propagate instead of deadlock
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
