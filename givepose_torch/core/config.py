"""Configuration of the PyTorch port.

The port keeps its own copy of ``givepose_tpu/core/config.py``'s
``DataConfig``, ``ModelConfig``, ``LossConfig``, ``TrainConfig``,
``EvalConfig`` and ``Config``: same field names, same defaults, so a
configuration translates one to one.  The command-line overrides
(``parse_overrides``) come with the CLI slice.  Only ``dcn_impl`` takes
other values, because the kernels differ:

  * ``auto``  - the CUDA kernel for CUDA tensors, the plain PyTorch version
    for CPU tensors;
  * ``cuda``  - the CUDA kernel only (raises on a CPU tensor);
  * ``torch`` - the plain PyTorch version on any device.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

import torch

DCN_IMPLS = ("auto", "cuda", "torch")


@dataclass(frozen=True)
class DataConfig:
    obj_c: int = 6
    dataset: str = "CAMERA+Real"          # Real | CAMERA | CAMERA+Real | wild6d
    dataset_dir: str = "./data/NOCS"
    ivfc_dir: str = "./data/IVFC"
    syn_ratio: float = 3.0                # CAMERA:Real resampling ratio
    per_obj: str = "all"
    ban_mug: bool = False
    dzi_pad_scale: float = 1.5
    dzi_type: str = "uniform"             # uniform | uniform_sr | roi10d | none
    dzi_scale_ratio: float = 0.25
    dzi_shift_ratio: float = 0.25
    img_size: int = 256
    out_res: int = 64
    roi_mask_r: int = 3
    roi_mask_pro: float = 0.5
    color_aug_type: str = "new"
    color_aug_prob: float = 0.8
    color_aug_syn_only: bool = False
    num_workers: int = 4


@dataclass(frozen=True)
class ModelConfig:
    main_backbone: str = "convnext"       # convnext (convnext_base stride-32 1024ch)
    mask_attention_type: str = "none"     # none | mul | concat
    nocsmap_encoder: str = "conv"         # conv (MAPEncoder/DCNv3) | att (ViT)
    use_dcn: str = "dcnv3"                # dcnv3 | '' (plain conv)
    dcn_impl: str = "auto"                # auto | cuda | torch (see module doc)
    # > 0 clamps DCNv3 sampling to +-window px around each query
    # (ops/dcnv3.py clamp_to_window); 0 keeps unbounded offsets
    dcn_window: int = 0
    r_type: str = "allo_rot6d"            # allo_rot6d | ego_rot6d | allo_quat | ...
    t_type: str = "site"                  # site | center
    z_type: str = "REL"                   # REL | ABS
    flat_op: str = "flatten"              # flatten | avg | avg-max | avg-max-min
    drop_prob: float = 0.0
    dropblock_size: int = 5
    size_head_out_dim: int = 3
    pose_head_featdim: int = 128
    feat_ts: int = 128                    # size-head feature channels
    use_hw: bool = True
    feat_dim: int = 24
    sn_backbone: str = "mobilenetv3s"
    use_scale_net: bool = True
    resize_full: bool = True
    sn_path: str = ""
    compute_dtype: str = "bfloat16"       # bfloat16 | float32 (matmul/conv dtype)
    param_dtype: str = "float32"
    gelu_exact: bool = False              # erf GELU instead of the tanh form
    quant_dense: bool = False             # int8 serving mode (not ported yet)

    def torch_dtype(self) -> torch.dtype:
        """The compute dtype as a torch dtype."""
        if self.compute_dtype == "bfloat16":
            return torch.bfloat16
        if self.compute_dtype == "float32":
            return torch.float32
        raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")


@dataclass(frozen=True)
class LossConfig:
    pose_loss_type: str = "l1"            # l1 | smoothl1
    r_loss: str = "l1"                    # l1 | angle
    rot_1_w: float = 1.0
    tran_w: float = 1.0
    size_w: float = 1.0
    scale_w: float = 2.0
    coor_w: float = 0.1
    prop_pm_w: float = 1.0
    coor_gt_sym: str = "rot"
    rot_sym_num: int = 30                 # rotations in train-time symmetry bank


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 48
    total_epoch: int = 300
    train_size: int = 16000               # images per epoch
    accumulate: int = 1                   # gradient accumulation steps
    lr: float = 1e-3
    lr_scheduler_name: str = "flat_and_anneal"
    anneal_method: str = "cosine"
    anneal_point: float = 0.72
    optimizer_type: str = "Ranger"        # Ranger (the others: not ported)
    weight_decay: float = 0.01
    warmup_factor: float = 0.001
    warmup_iters: int = 100
    warmup_method: str = "linear"
    grad_clip_norm: float = 5.0
    save_every: int = 50
    keep_checkpoints: int = 0             # newest N ckpt_* kept; 0 = all
    log_every: int = 100
    model_save: str = "output/model_save"
    resume: bool = False
    resume_model: str = ""
    resume_point: int = 0
    seed: int = 0
    mesh_shape: tuple = ()
    # read nowhere, as in the JAX package: kept so configurations match
    remat_backbone: bool = True
    restart_every: int = 0                # epochs; 0 = disabled
    bn_recal_batches: int = 32
    bn_freeze_point: float = 0.75


@dataclass(frozen=True)
class EvalConfig:
    eval_refine_mug: bool = True
    eval_inference_only: bool = False
    eval_precise: bool = False
    real_iou: bool = True
    use_match_for_pose: bool = True
    result_dir: str | None = None
    eval_batch_size: int = 1
    use_allo: bool = True
    eval_size: bool = True
    detection_dir: str = ""
    max_instances: int = 24
    use_umeyama: bool = False


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)
