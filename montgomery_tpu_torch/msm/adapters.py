"""Group adapters: the batched-group interfaces the MSM engine needs.

Counterpart of `ProjectiveAdapter`, `AffineAccumAdapter` and
`EdwardsAdapter` in `montgomery_tpu/msm/adapters.py`. Point batches are
NamedTuples whose planes have shape (n, *batch) (an AffineBatch's infinity
mask (*batch)); the batched-affine accumulation keeps points as packed
(2n+1, M) rows, the Twisted Edwards one as packed (4n, M) rows.
"""

from __future__ import annotations

import torch

from ..curves.affine import AffineOps
from ..curves.edwards import EdwardsBatch, EdwardsOps
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

    def combine(self, W, c: int):
        return self.proj.combine(W, c)

    def select(self, mask, a, b):
        return self.proj.select(mask, a, b)

    def gather(self, P, idx):
        return ProjectiveBatch(*[a.index_select(a.dim() - 1, idx) for a in P])


class AffineAccumAdapter:
    """Batched-affine bucket accumulation on packed rows (one shared batch
    inversion per pair round) with the safe add, or with unsafe the unsafe
    one; the bucket sums leave as projective points. A bucket whose sum is
    infinite (P + (-P), a tangent at y = 0) keeps its inf row through the
    rounds and the extraction."""

    def __init__(self, aff: AffineOps, proj: ProjectiveOps, unsafe: bool = False):
        self.aff, self.proj, self.unsafe = aff, proj, unsafe
        self.f = aff.f
        self.rounds: list[tuple[str, int, int]] = []  # of the last accumulation

    # planar members: AffineBatch planes (n, *batch), the planar adds

    def zero_like(self, shape, device) -> AffineBatch:
        z = self.f.zeros(tuple(shape), device)
        return AffineBatch(z, z, torch.ones(tuple(shape), dtype=torch.bool, device=device))

    def from_points(self, A: AffineBatch) -> AffineBatch:
        return A

    def add(self, P: AffineBatch, Q: AffineBatch, valid=None) -> AffineBatch:
        """The planar safe add; with unsafe, the unsafe one (`valid` excludes
        lanes from its shared inversion; the safe add takes every lane)."""
        if self.unsafe:
            return self.aff.batch_add_unsafe(P, Q, valid=valid)
        return self.aff.batch_add(P, Q)

    def select(self, mask, a: AffineBatch, b: AffineBatch) -> AffineBatch:
        return self.aff.select(mask, a, b)

    def gather(self, P: AffineBatch, idx) -> AffineBatch:
        return AffineBatch(*[a.index_select(a.dim() - 1, idx) for a in P])

    def neg_where(self, P: AffineBatch, mask) -> AffineBatch:
        f = self.f
        return AffineBatch(P.x, f._sel(mask, f.neg(P.y), P.y), P.inf)

    # packed members: the engine's rows (2n+1, M)

    @property
    def packed_rows(self) -> int:
        return self.aff.packed_rows

    def pack_rows(self, A: AffineBatch) -> torch.Tensor:
        return self.aff.pack_rows(A)

    def unpack_rows(self, P: torch.Tensor) -> AffineBatch:
        return self.aff.unpack_rows(P)

    def add_packed(self, A, B, sA, sB, valid) -> torch.Tensor:
        return self.aff.add_packed(A, B, sA, sB, valid, unsafe=self.unsafe)

    def buckets_from_packed(self, Bp: torch.Tensor, valid: torch.Tensor) -> AffineBatch:
        """Gathered packed buckets -> points; empty buckets become infinity."""
        ub = self.unpack_rows(Bp)
        return AffineBatch(ub.x, ub.y, ub.inf | torch.logical_not(valid))

    def to_projective(self, A: AffineBatch) -> ProjectiveBatch:
        return self.proj.from_affine(A)


class EdwardsAdapter:
    """Twisted Edwards MSM in extended coordinates: packed accumulation
    rounds (one `ed_add_packed` launch each, no inversion) and the bucket
    reduction in the same coordinates (`ed_add`, and `ed_dbl` for
    double_n) and the window combine in one Horner launch (`ed_combine`).
    The unified add needs no masks: an empty bucket is the identity
    (0 : 1 : 1 : 0)."""

    def __init__(self, ed: EdwardsOps):
        self.ed = ed
        self.f = ed.f
        self.rounds: list[tuple[str, int, int]] = []  # of the last accumulation

    def zero_like(self, shape, device) -> EdwardsBatch:
        f = self.f
        z = torch.zeros((f.n, *shape), dtype=torch.int32, device=device)
        one = f.const_plane(f.R_mod_p, z)
        return EdwardsBatch(z, one, one, z)

    def add(self, P, Q):
        return self.ed.add(P, Q)

    def double_n(self, P, k: int):
        return self.ed.double_n(P, k)

    def combine(self, W, c: int):
        return self.ed.combine(W, c)

    def select(self, mask, a, b):
        return self.ed.select(mask, a, b)

    def gather(self, P, idx):
        return EdwardsBatch(*[a.index_select(a.dim() - 1, idx) for a in P])

    @property
    def packed_rows(self) -> int:
        return self.ed.packed_rows

    def pack_rows(self, P: EdwardsBatch) -> torch.Tensor:
        return self.ed.pack_rows(P)

    def unpack_rows(self, A: torch.Tensor) -> EdwardsBatch:
        return self.ed.unpack_rows(A)

    def add_packed(self, A, B, sA, sB, valid) -> torch.Tensor:
        return self.ed.add_packed(A, B, sA, sB, valid)

    def buckets_from_packed(self, Bp: torch.Tensor, valid: torch.Tensor) -> EdwardsBatch:
        """Gathered packed buckets -> points; empty buckets become the identity."""
        ub = self.unpack_rows(Bp)
        return self.ed.select(valid, ub, self.ed.zero_like(ub))
