#!/usr/bin/env python3
"""Spread of ``chip_smoke.py``'s train-step comparison of the DCNv3 kernels
against the plain DCNv3 version, over model states and batches.

    python3 tools/train_path_spread.py

``chip_smoke.py`` compares one train step with the kernels against one
with the plain version at a single point: the seeded weights before any
step, on its seeded batch.  This script runs the same comparison
(``chip_smoke.compare_train_paths``) at that point three times, after
each of six training steps at batch 48, and at the seeded weights on three
other seeded batches, and prints every comparison's lines.  A bar that
fails is printed and the script goes on.  It needs one NVIDIA GPU.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("train_path_spread: needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from givepose_torch.core.config import Config
    from givepose_torch.ops import _build
    from givepose_torch.train import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.log(smoke.card_line())
    _build.build()
    cfg = Config()
    state = init_train_state(cfg, backbone_variant="base", seed=0)
    smoke.perturb_dcn(state.model, seed=1)
    initial = smoke.snapshot(state.model)
    step = make_train_step(state.model, cfg)
    batch = smoke.train_batch(smoke.TRAIN_BATCH, seed=5)

    def compare(label: str, sd: dict, b: dict) -> None:
        smoke.log(f"== {label}")
        try:
            smoke.compare_train_paths(sd, b)
        except SystemExit:
            smoke.log("   a bar failed (above)")

    for i in range(3):
        compare(f"seeded weights, batch seed 5, run {i + 1}", initial, batch)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for i in range(6):
        step(state, batch, gen)
        compare(f"after step {i + 1}, batch seed 5",
                smoke.snapshot(state.model), batch)
    for seed in (21, 22, 23):
        compare(f"seeded weights, batch seed {seed}", initial,
                smoke.train_batch(smoke.TRAIN_BATCH, seed=seed))


if __name__ == "__main__":
    main()
