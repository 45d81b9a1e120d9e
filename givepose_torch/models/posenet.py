"""PoseNet inference (PyTorch, NHWC at the boundary).

Port of ``givepose_tpu/models/posenet.py``:

  roi_img (B,256,256,3)
   └─ ConvNeXt ─ feat (B,8,8,1024)
       ├─ SizeHead ─ size residual + normalised mean size
       ├─ TopDownXyzHead ─ NOCS map (B,64,64,3)
       │    └─ MAPEncoder (DCNv3) ─ nocs_feat (B,8,8,256)
       ├─ feat_reducer 1x1 ─ (B,8,8,256) ─ concat ─ (B,8,8,512)
       │    └─ TopDownXyzHead ─ IVFC map (B,64,64,3)
       └─ IVFC ⊕ roi_coord_2d ─ ConvPnPNet ─ rot6d, (cx,cy,z)
  rot6d → R → allo→ego with centroid-z backprojection → (R, t)

``train=True`` is the training forward: SizeHead normalises with batch
statistics (updating its running ones) and applies dropout with a mask
drawn from the caller's ``generator``.  DropBlock and drop-path
(``drop_prob > 0``) are not ported and raise when the model is built.
``quant_dense=True`` (int8 backbone MLPs) serves only: a training forward
raises, as the JAX package asserts.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from givepose_torch.core.config import ModelConfig
from givepose_torch.geometry.pose_assembly import pose_from_pred_centroid_z
from givepose_torch.geometry.rotations import get_rot_mat
from givepose_torch.models.convnext import ConvNeXt, convnext_base, convnext_tiny
from givepose_torch.models.heads import (
    ConvPnPNet,
    MAPEncoder,
    SizeHead,
    TopDownXyzHead,
)
from givepose_torch.models.layers import Conv2d


class PoseNet(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 backbone_variant: str = "base",
                 backbone_depths: Sequence[int] = (3, 3, 27, 3),
                 backbone_dims: Sequence[int] = (128, 256, 512, 1024),
                 img_size: int = 256):
        super().__init__()
        if cfg.nocsmap_encoder != "conv":
            raise NotImplementedError(
                f"nocsmap_encoder={cfg.nocsmap_encoder!r} (the attention "
                "encoder) is not ported yet (ROADMAP queue A, item 10)")
        cd = cfg.torch_dtype()
        self.cfg = cfg
        self.compute_dtype = cd
        gelu = "gelu_exact" if cfg.gelu_exact else "gelu"
        quant = cfg.quant_dense
        if backbone_variant == "base":
            self.backbone = convnext_base(cd, cfg.gelu_exact, quant)
        elif backbone_variant == "custom":
            self.backbone = ConvNeXt(backbone_depths, backbone_dims,
                                     gelu_exact=cfg.gelu_exact, quant=quant,
                                     compute_dtype=cd)
        elif backbone_variant == "tiny":
            self.backbone = convnext_tiny(cd, cfg.gelu_exact, quant)
        else:
            raise ValueError(f"unknown backbone_variant {backbone_variant}")
        feat_c = self.backbone.dims[-1]
        map_hw = img_size // 4

        self.size_head = SizeHead(feat_c, cfg.feat_ts, cfg.size_head_out_dim,
                                  compute_dtype=cd)
        self.xyz_nocs_head = TopDownXyzHead(feat_c, act=gelu,
                                            compute_dtype=cd)
        self.nocs_encoder = MAPEncoder(3, use_dcn=cfg.use_dcn,
                                       dcn_impl=cfg.dcn_impl,
                                       dcn_window=cfg.dcn_window,
                                       gelu_exact=cfg.gelu_exact,
                                       drop_prob=cfg.drop_prob,
                                       dropblock_size=cfg.dropblock_size,
                                       compute_dtype=cd)
        self.feat_reducer = Conv2d(feat_c, 256, 1, compute_dtype=cd)
        self.xyz_deform_head = TopDownXyzHead(512, act=gelu,
                                              compute_dtype=cd)
        self.pnp_net = ConvPnPNet(
            5, map_hw, featdim=cfg.pose_head_featdim,
            rot_dim=4 if "quat" in cfg.r_type else 6,
            mask_attention_type=cfg.mask_attention_type,
            flat_op=cfg.flat_op, drop_prob=cfg.drop_prob,
            dropblock_size=cfg.dropblock_size, compute_dtype=cd)

    def forward(self, batch: dict, train: bool = False,
                is_wild6d: bool = False,
                generator: torch.Generator | None = None) -> dict:
        if train and generator is None:
            raise ValueError("train=True needs a torch.Generator on the "
                             "model's device for SizeHead's dropout")
        if train and self.cfg.quant_dense:
            raise ValueError("quant_dense=True is an int8 serving mode: "
                             "rounding has zero gradient, so it does not "
                             "train")
        cd = self.compute_dtype
        cfg = self.cfg
        feat = self.backbone(batch["roi_img"].to(cd))        # (B,8,8,C)
        size_resid = self.size_head(feat, train=train, generator=generator)

        cx, cy, cz = self.xyz_nocs_head(feat)
        coor_nocs = torch.cat([cx, cy, cz], dim=-1)          # f32
        nocs_feat = self.nocs_encoder(coor_nocs.to(cd))

        feat256 = self.feat_reducer(feat)
        feat_cat = torch.cat([feat256, nocs_feat.to(cd)], dim=-1)
        ix, iy, iz = self.xyz_deform_head(feat_cat)
        coor_ivfc = torch.cat([ix, iy, iz], dim=-1)

        pnp_in = torch.cat([coor_ivfc.to(cd), batch["roi_coord_2d"].to(cd)],
                           dim=-1)
        rot_raw, t_raw, _ = self.pnp_net(
            pnp_in, mask_attention=batch.get("roi_mask_out"))

        mean_size = batch["mean_size"].float()
        pred_size = size_resid + mean_size / torch.linalg.vector_norm(
            mean_size, dim=1, keepdim=True)

        rot_m = get_rot_mat(rot_raw, cfg.r_type)
        centroids = t_raw[:, :2]
        if cfg.t_type == "center":
            centroids = centroids * 0
        rot_ego, trans = pose_from_pred_centroid_z(
            rot_m,
            pred_centroids=centroids,
            pred_z_vals=t_raw[:, 2:3],
            roi_cams=batch["cam_K"].float(),
            roi_centers=batch["bbox_center"].float(),
            resize_ratios=batch["resize_ratio"].float(),
            roi_whs=batch["roi_wh"].float(),
            is_allo="allo" in cfg.r_type,
            z_type=cfg.z_type,
            is_wild6d=is_wild6d,
        )
        return {
            "rot": rot_ego,
            "trans": trans,
            "size": pred_size,
            "nocs_coor": coor_nocs,
            "ivfc_coor": coor_ivfc,
            "rot_raw": rot_raw,
            "t_raw": t_raw,
        }
