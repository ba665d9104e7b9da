"""Group adapter: the batched-group interface the MSM engine needs.

Counterpart of `ProjectiveAdapter` in `montgomery_tpu/msm/adapters.py`.
Point batches are ProjectiveBatch tuples whose planes have shape (n, *batch).
"""

from __future__ import annotations

import torch

from ..curves.projective import AffineBatch, ProjectiveBatch, ProjectiveOps


class ProjectiveAdapter:
    """Weierstrass MSM accumulation in complete projective coordinates."""

    def __init__(self, proj: ProjectiveOps):
        self.proj = proj
        self.f = proj.f

    def zero_like(self, shape, device) -> ProjectiveBatch:
        f = self.f
        z = torch.zeros((f.n, *shape), dtype=torch.int32, device=device)
        return ProjectiveBatch(z, f.const_plane(f.R_mod_p, z), z)

    def from_points(self, A: AffineBatch) -> ProjectiveBatch:
        return self.proj.from_affine(A)

    def add(self, P, Q):
        return self.proj.add(P, Q)

    def double_n(self, P, k: int):
        return self.proj.double_n(P, k)

    def select(self, mask, a, b):
        return self.proj.select(mask, a, b)

    def gather(self, P, idx):
        return ProjectiveBatch(*[a.index_select(a.dim() - 1, idx) for a in P])
