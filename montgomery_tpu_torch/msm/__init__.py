"""Pippenger MSM engine and the curve context."""

from .adapters import ProjectiveAdapter
from .api import WeierstrassMsm
from .pippenger import msm_digits, window_size
