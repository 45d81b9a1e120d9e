from givepose_torch.models.posenet import PoseNet
from givepose_torch.models.scale_net import ScaleNet, build_scalenet
from givepose_torch.models.mobilenet import MobileNetV3Small
