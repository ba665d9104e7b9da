"""Batched curve arithmetic over limb planes."""

from .projective import AffineBatch, ProjectiveBatch, ProjectiveOps
