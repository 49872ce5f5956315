from acmpc_tpu_torch.models.fpn_resnet18 import FPNResNet18

__all__ = ["FPNResNet18"]
