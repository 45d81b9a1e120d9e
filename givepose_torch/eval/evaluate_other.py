"""Re-score third-party result pickles (reference evaluation/
evaluate_other.py:24+, driven by FLAGS.result_dir).

Port of ``givepose_tpu/eval/evaluate_other.py``.  Other methods' eval
dumps use the same per-image dict schema as pred_result.pkl; this loads
them (one pkl or a directory of pkls) and runs the same two-pass mAP
harness, so the numbers compare like for like.  The pickles are trusted
input: unpickling can run code.

    python -m givepose_torch.eval.evaluate_other <pkl or directory>
"""

from __future__ import annotations

import glob
import os
import pickle

from givepose_torch.core.config import Config
from givepose_torch.eval.evaluate import evaluate_results


def load_results(result_path: str) -> list:
    """Load a results list from a pkl file or all pkls in a directory."""
    if os.path.isfile(result_path):
        with open(result_path, "rb") as f:
            data = pickle.load(f)
        return data if isinstance(data, list) else [data]
    results = []
    for p in sorted(glob.glob(os.path.join(result_path, "*.pkl"))):
        with open(p, "rb") as f:
            data = pickle.load(f)
        if isinstance(data, list):
            results.extend(data)
        else:
            results.append(data)
    return results


def rescore(result_path: str, cfg: Config | None = None, log=print):
    cfg = cfg or Config()
    results = load_results(result_path)
    if not results:
        raise FileNotFoundError(f"no results under {result_path}")
    log(f"rescoring {len(results)} images from {result_path}")
    return evaluate_results(results, cfg, log=log)


if __name__ == "__main__":
    import sys

    rescore(sys.argv[1])
