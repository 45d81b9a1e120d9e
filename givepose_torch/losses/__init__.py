from givepose_torch.losses.pose_loss import (
    PoseLossFn,
    pnp_loss,
    scale_loss,
    soft_label_cross_entropy,
    laplacian_aleatoric_loss,
    gaussian_aleatoric_loss,
    backbone_mask_loss,
)
