"""Export CLI: serialize the PoseNet forward for serving (``torch.export``).

Usage:
  python -m givepose_torch.cli.export --out posenet_b128.pt2 \\
      --batch_size 128 [--use_dcn dcnv3] [--device cuda|cpu]

Writes ONE artifact file.  The weights stay in the checkpoint; a serving
process does:

  from givepose_torch.eval.serving import load_exported_file
  fn = load_exported_file("posenet_b128.pt2")
  out = fn(state_dict, batch)      # batch: serving_batch_spec shapes

Port of ``givepose_tpu/cli/export.py``: the same flags and defaults
(``--use_dcn`` defaults to '' here, unlike ``ModelConfig``), with
``--dcn_impl auto|cuda|torch`` and ``--device`` for ``--platforms``: an
artifact is exported for the one device it serves on (``eval/serving.py``).
"""

from __future__ import annotations

import argparse
import sys

import torch

from givepose_torch.core.config import DCN_IMPLS, ModelConfig
from givepose_torch.eval.serving import export_posenet, save_exported
from givepose_torch.models.posenet import PoseNet


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--backbone", default="base")
    p.add_argument("--use_dcn", default="")
    p.add_argument("--dcn_window", type=int, default=0)
    p.add_argument("--dcn_impl", default="auto", choices=DCN_IMPLS,
                   help="auto and cuda put the DCNv3 kernel's operator in "
                        "the graph; torch the plain version's ops")
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--gelu_exact", action="store_true",
                   help="exact erf GELU, for artifacts that will serve "
                        "weights trained with it")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the device the artifact serves on")
    args = p.parse_args(argv)

    cfg = ModelConfig(compute_dtype=args.compute_dtype,
                      use_dcn=args.use_dcn, dcn_window=args.dcn_window,
                      dcn_impl=args.dcn_impl, gelu_exact=args.gelu_exact)
    # only shapes enter the artifact (the weights are call arguments), so
    # a model on the meta device is enough: no checkpoint is read here
    with torch.device("meta"):
        model = PoseNet(cfg, args.backbone, img_size=args.img_size)
    weights = model.state_dict()
    blob = export_posenet(weights, cfg=cfg, backbone_variant=args.backbone,
                          batch_size=args.batch_size,
                          img_size=args.img_size, device=args.device)
    save_exported(args.out, blob)
    nparams = sum(p.numel() for p in model.parameters())
    print(f"exported {args.out}: {len(blob) / 1024:.1f} KB, batch "
          f"{args.batch_size}, device {args.device}, {nparams / 1e6:.1f} M "
          f"params expected at call time")


if __name__ == "__main__":
    main(sys.argv[1:])
