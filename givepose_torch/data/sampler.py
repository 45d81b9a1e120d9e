"""Epoch resampling: CAMERA:Real = syn_ratio:1.

Reference engine/train.py:88-113: each epoch draws train_size indices from
a rolling page; when exhausted it refills with
``sample(camera, syn_ratio * n_repeat * real_len) + all real`` shuffled.
Functionally: per epoch, Real samples all appear ~once per refill and
CAMERA samples are drawn at syn_ratio x the Real count.

Copy of ``givepose_tpu/data/sampler.py``: the same
``np.random.default_rng`` draws, so the same index stream for a seed.
"""

from __future__ import annotations

import numpy as np


class EpochSampler:
    def __init__(self, camera_len: int, real_len: int, train_size: int,
                 syn_ratio: float = 3.0, seed: int = 0):
        self.camera_len = camera_len
        self.real_len = real_len
        self.train_size = train_size
        self.syn_ratio = syn_ratio
        self.rng = np.random.default_rng(seed)
        self._pool: list[int] = []

    def _refill(self, needed: int):
        if self.camera_len and self.real_len:
            n_repeat = int(needed
                           // ((self.syn_ratio + 1) * self.real_len)) + 1
            n_cam = int(self.syn_ratio * n_repeat * self.real_len)
            # reference: random.sample(camera_indices, n_cam) — without
            # replacement, and it CRASHES when n_cam > camera_len
            # (Real-heavy configs).  We keep the requested ratio instead:
            # full without-replacement passes plus a remainder sample.
            parts = []
            remaining = n_cam
            while remaining >= self.camera_len:
                parts.append(self.rng.permutation(self.camera_len))
                remaining -= self.camera_len
            if remaining:
                parts.append(self.rng.choice(self.camera_len,
                                             size=remaining,
                                             replace=False))
            cam = (np.concatenate(parts) if parts
                   else np.empty(0, dtype=np.int64))
            real = np.arange(self.camera_len,
                             self.camera_len + self.real_len)
            batch = np.concatenate([cam, real])
        else:
            total = self.camera_len + self.real_len
            reps = needed // max(total, 1) + 1
            batch = np.tile(np.arange(total), reps)
        self.rng.shuffle(batch)
        self._pool.extend(batch.tolist())

    def epoch_indices(self) -> np.ndarray:
        while len(self._pool) < self.train_size:
            self._refill(self.train_size - len(self._pool))
        out = np.asarray(self._pool[: self.train_size])
        del self._pool[: self.train_size]
        return out
