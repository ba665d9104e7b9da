"""Scalar pipeline: GLV decomposition and signed window digits, and the
non-GLV signed digits."""

from .device import (GlvDevice, digits_glv_device, glv_device, ints_to_limbs_np,
                     signed_digits_device)
from .glv import GlvParams, glv_params
from .slicing import num_windows, signed_digits
