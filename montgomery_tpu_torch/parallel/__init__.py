"""Mesh-sharded MSM over several devices, driven from one process."""

from .sharded import Mesh, make_mesh, msm_full_sharded, msm_sharded, shard_points
