"""Small host-side helpers of the port."""

from acmpc_tpu_torch.utils.radians import convert_radians_to_plus_minus_pi

__all__ = ["convert_radians_to_plus_minus_pi"]
