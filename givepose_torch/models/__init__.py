from givepose_torch.models.posenet import PoseNet
from givepose_torch.models.scale_net import ScaleNet, build_scalenet
from givepose_torch.models.convnext import (
    ConvNeXt,
    convnext_base,
    convnext_tiny,
)
from givepose_torch.models.heads import (
    TopDownXyzHead,
    MAPEncoder,
    ConvPnPNet,
    SizeHead,
)
from givepose_torch.models.dcnv3_module import DCNv3, DCNv3Conv
from givepose_torch.models.mobilenet import MobileNetV3Small
