"""Pippenger MSM engine and the curve context."""

from .adapters import EdwardsAdapter, ProjectiveAdapter
from .api import EdwardsMsm, WeierstrassMsm
from .pippenger import msm_digits, window_size
