"""Evaluation CLI (reference evaluation/evaluate.py:27-286).

Port of ``givepose_tpu/cli/evaluate.py``:

  python -m givepose_torch.cli.evaluate --dataset Real \\
      --dataset_dir ./data/NOCS --resume_model <ckpt> --sn_path <sn_ckpt>

runs PoseNet and the ScaleNet on the GPU, unless ``--device cpu`` is
given, over the test split's detections and logs both mAP passes into
``<model_save>/eval_result_<model>/``, beside the ``pred_result.pkl``
cache.  ``--resume_model`` and ``--sn_path`` name the port's own
checkpoints: a ``TrainState`` checkpoint written by ``cli/train.py``
(``ckpt_N``) or ``cli/train_scale.py`` (``scale_ckpt_N``), or a bare
``state_dict``.  A JAX run's weights reach the port through
``models.convert_from_flax`` (``flax_to_state_dict``,
``flax_train_state_to_torch``).
"""

from __future__ import annotations

import os
import sys

import torch

from givepose_torch.cli.train import split_device_flag
from givepose_torch.core.config import Config, parse_overrides
from givepose_torch.core.logging_utils import setup_logger
from givepose_torch.eval import (
    NocsEvalReader,
    WildEvalReader,
    build_instance_batch,
    evaluate_results,
    run_inference,
)
from givepose_torch.eval.serving import build_posenet, resolve_device
from givepose_torch.models.scale_net import build_scalenet


def _restore_variables(path: str) -> dict:
    """The model ``state_dict`` of a checkpoint written by the port's
    training CLIs (``step``/``model``/``optimizer``), or the bare
    ``state_dict`` at ``path``."""
    saved = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    if isinstance(saved, dict) and "model" in saved and "step" in saved:
        return saved["model"]
    return saved


def evaluate(argv=None, backbone_variant: str = "base",
             posenet_variables: dict | None = None,
             scalenet_variables: dict | None = None, device=None):
    """``posenet_variables`` / ``scalenet_variables``: ``state_dict``s of
    the port's models, used as given (no checkpoint is read); otherwise
    seeded inits, overwritten by ``--resume_model`` and ``--sn_path``."""
    argv, flag_device = split_device_flag(
        list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(device or flag_device)
    cfg = parse_overrides(Config(), argv)
    model_name = (os.path.basename(cfg.train.resume_model).split(".")[0]
                  if cfg.train.resume_model else "random")
    out_dir = os.path.join(cfg.train.model_save,
                           f"eval_result_{model_name}")
    os.makedirs(out_dir, exist_ok=True)
    logger = setup_logger("eval", os.path.join(out_dir, "log_eval.txt"))

    is_wild = cfg.data.dataset == "wild6d"
    if is_wild:
        reader = WildEvalReader(cfg.data.dataset_dir,
                                per_obj=cfg.data.per_obj)
        source = "Real"
        cache = os.path.join(out_dir,
                             f"pred_result_{cfg.data.per_obj}.pkl")
    else:
        reader = NocsEvalReader(cfg.data.dataset, cfg.data.dataset_dir,
                                detection_dir=cfg.eval.detection_dir
                                or None,
                                refine_mug=cfg.eval.eval_refine_mug,
                                per_obj=cfg.data.per_obj)
        source = cfg.data.dataset
        cache = os.path.join(out_dir, "pred_result.pkl")

    if posenet_variables is None:
        # scan for the first image that is readable AND has instances —
        # image 0 being corrupt or detection-less must not abort a run
        # whose remaining images are fine (run_inference already skips
        # such images per-image)
        built = None
        for probe in range(len(reader)):
            item = reader.read(probe)
            if item is None:
                continue
            built = build_instance_batch(
                item[0], item[1], item[2], source,
                img_size=cfg.data.img_size, out_res=cfg.data.out_res,
                max_instances=cfg.eval.max_instances)
            if built is not None:
                break
        assert built is not None, "no readable eval sample with instances"
        if cfg.train.resume_model:
            posenet_variables = _restore_variables(cfg.train.resume_model)
        if cfg.model.sn_path and scalenet_variables is None:
            scalenet_variables = _restore_variables(cfg.model.sn_path)

    model = build_posenet(cfg.model, backbone_variant, device=device,
                          seed=0, state_dict=posenet_variables,
                          img_size=cfg.data.img_size)
    scale_model = build_scalenet(cfg.model.feat_dim, cfg.model.use_hw,
                                 device, seed=1,
                                 state_dict=scalenet_variables)

    results = run_inference(reader, model, scale_model, cfg, source=source,
                            is_wild6d=is_wild, cache_path=cache,
                            progress=lambda i, n: logger.info(
                                "inference %d/%d", i, n))
    if cfg.eval.eval_inference_only:
        return None
    return evaluate_results(results, cfg, log=logger.info)


if __name__ == "__main__":
    evaluate()
