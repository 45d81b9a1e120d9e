"""``tools/overfit_proof.py`` asks for repeatable arithmetic before its
first model is built: cuDNN's deterministic algorithms without the
benchmark-driven choice, cuBLAS's fixed workspace and PyTorch's
deterministic implementations (warning, not raising, where an op has
none).  The CLIs are replaced by a stand-in that records the flags and
stops the run."""

from __future__ import annotations

import os
import sys
import tempfile

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import overfit_proof  # noqa: E402


class _Stop(Exception):
    pass


def test_determinism_is_set_before_the_first_model(monkeypatch, tmp_path):
    import givepose_torch.cli.train as cli_train

    seen = {}

    def first_training(argv, **kw):
        seen.update(
            deterministic=torch.backends.cudnn.deterministic,
            benchmark=torch.backends.cudnn.benchmark,
            algorithms=torch.are_deterministic_algorithms_enabled(),
            warn_only=torch.is_deterministic_algorithms_warn_only_enabled(),
            workspace=os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
        raise _Stop

    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    monkeypatch.setattr(cli_train, "train", first_training)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the fixture
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    try:
        with pytest.raises(_Stop):
            overfit_proof.run(steps=1, sn_steps=1, device="cpu",
                              out_json=str(tmp_path / "out.json"))
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.backends.cudnn.benchmark = saved[1]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])
    assert seen == {"deterministic": True, "benchmark": False,
                    "algorithms": True, "warn_only": True,
                    "workspace": ":4096:8"}
    # the recipe's bars are the JAX package's
    assert (overfit_proof.IOU25_BAR, overfit_proof.DEG10_CM10_BAR) == (95.0,
                                                                       80.0)
