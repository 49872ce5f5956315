"""Heading-angle convention helper, the port's copy of
``acmpc_tpu/utils/radians.py``: maps a sim heading to (-pi, pi] with the
pi/2 forward offset."""

import numpy as np


def convert_radians_to_plus_minus_pi(radians):
    return (((np.pi / 2) - radians + np.pi) % (2 * np.pi)) - np.pi
