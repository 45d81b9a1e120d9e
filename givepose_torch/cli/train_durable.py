"""Durable training wrapper: a fresh process every ``restart_every`` epochs.

Port of ``givepose_tpu/cli/train_durable.py``:

  python -m givepose_torch.cli.train_durable --restart_every 20 \\
      --dataset CAMERA+Real --dataset_dir ... --total_epoch 300 ...

Each round runs ``cli.train`` with the given flags; the trainer saves a
checkpoint and exits with code 75 (EX_TEMPFAIL) when its epoch quota is
reached, and this wrapper relaunches it with ``--resume 1`` (epoch
derived from the checkpointed step, sampler stream replayed), so a long
campaign survives in bounded rounds.  Any other exit code stops the
campaign and is propagated.
"""

from __future__ import annotations

import subprocess
import sys


def train_durable(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--restart_every" not in argv:
        argv += ["--restart_every", "20"]
    round_idx = 0
    while True:
        cmd = [sys.executable, "-m", "givepose_torch.cli.train", *argv]
        if round_idx > 0:
            cmd += ["--resume", "1"]
        print(f"[train_durable] round {round_idx}: {' '.join(cmd)}",
              flush=True)
        rc = subprocess.run(cmd).returncode
        if rc != 75:
            return rc
        round_idx += 1


if __name__ == "__main__":
    sys.exit(train_durable())
