"""Sharded MSM: points split over the devices of a mesh, bucket grids
combined with a butterfly reduce-scatter whose operator is the group add.

Counterpart of `montgomery_tpu/parallel/sharded.py`. The JAX package runs
one program per device under `jax.shard_map`; here one process drives every
device of the mesh in turn (a single controller, as `shard_map` on one host):
each shard's tensors live on its device, so its kernels launch there, and
every step runs inside that device's scope. A mesh may name one device
several times, which gives logical shards on one device (the counterpart of
the JAX package's virtual CPU mesh), for example `make_mesh(8,
devices=["cpu"] * 8)` on a host without a card.

The collectives become copies between devices: `ppermute` is a copy of the
half a shard gives up to its partner's device, `all_gather` a copy of every
shard's window sums to the mesh's first device, where the windows combine
once (the JAX package replicates that combine; every replica is the same
point). As there, the cross-shard combine ALWAYS runs in the complete
projective group (the caller's reduce group): shard grids hold empty buckets
and may hold equal or opposite bucket sums, which the unsafe affine add
cannot take. After the reduce-scatter shard d holds windows
[d K2 / D, (d + 1) K2 / D), K2 = ceil(K / D) D, the padding windows being
the identity; it reduces only those.

Nothing here writes into a tensor: a copy to the device a tensor is already
on returns the same tensor, so logical shards on one device share storage.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass

import torch

from ..msm.pippenger import _map, bucket_accumulate, combine_windows, window_sums


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices, one shard each (a device may repeat).
    `axis` names its one axis as the JAX package's mesh does; the MSMs'
    `axis` argument must name it (their signatures match the JAX package's)."""

    devices: tuple[torch.device, ...]
    axis: str = "dp"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis: str = "dp", devices=None) -> Mesh:
    """A mesh over `devices`, or over the first n_devices visible CUDA
    devices (all of them when None); raises when there are fewer. It never
    gives way to the CPU: pass devices=["cpu"] * D for CPU shards."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = count if n_devices is None else n_devices
        if n < 1 or n > count:
            raise RuntimeError(f"a mesh of {n} CUDA devices asked for, {count} visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [torch.device(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(f"a mesh of {n_devices} devices asked for, {len(devices)} given")
            devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices), axis)


def _check_size(mesh: Mesh) -> int:
    D = mesh.size
    if D & (D - 1):
        raise ValueError(f"the mesh size must be a power of two, got {D}")
    return D


def _scope(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


def _to(P, device: torch.device):
    """A point batch (or a tensor) on `device`; the same tensors if they are
    there already."""
    if isinstance(P, torch.Tensor):
        return P.to(device)
    return _map(lambda a: a.to(device), P)


def shard_points(points, digits: torch.Tensor, mesh: Mesh):
    """Split a point batch (planes (n, N), masks (N,)) and its digit or
    scalar-limb planes (rows, N) into one batch per shard: shard d holds
    columns [d N / D, (d + 1) N / D) on mesh.devices[d]. Returns (list of
    point batches, list of digit planes)."""
    D = _check_size(mesh)
    N = digits.shape[-1]
    if any(a.shape[-1] != N for a in points):
        raise ValueError(f"points and digits disagree on N: {[tuple(a.shape) for a in points]}, "
                         f"{tuple(digits.shape)}")
    if N % D:
        raise ValueError(f"{N} points do not split into {D} equal shards")
    m = N // D
    cols = [slice(d * m, (d + 1) * m) for d in range(D)]
    return ([_to(_map(lambda a, s=s: a[..., s], points), dev) for s, dev in zip(cols, mesh.devices)],
            [_to(digits[..., s], dev) for s, dev in zip(cols, mesh.devices)])


def _check_shards(mesh: Mesh, points, digits) -> int:
    D = _check_size(mesh)
    if len(points) != D or len(digits) != D or any(isinstance(P, torch.Tensor) for P in points):
        raise ValueError(f"expected one point batch and one digit plane per shard ({D}), as "
                         "shard_points returns them")
    return D


def _butterfly_allreduce(group, grids: list, mesh: Mesh) -> list:
    """All-reduce of the shards' bucket grids with the group add: log2(D)
    steps, shard d adding the grid of shard d ^ s. Every step reads the
    grids from before it. No MSM path calls it (the JAX package's neither:
    its MSMs reduce-scatter); it is kept beside the reduce-scatter, as
    there."""
    D, s = len(grids), 1
    while s < D:
        recv = [_to(grids[d ^ s], dev) for d, dev in enumerate(mesh.devices)]
        out = []
        for d, dev in enumerate(mesh.devices):
            with _scope(dev):
                out.append(group.add(grids[d], recv[d]))
        grids = out
        s <<= 1
    return grids


def _pad_windows(group, buckets, K: int, K2: int):
    """Pad the window axis (second to last) from K to K2 with the identity."""
    if K2 == K:
        return buckets
    L = buckets[0].shape[-1]
    ident = group.zero_like((K2 - K, L), buckets[0].device)
    return type(buckets)(*[torch.cat([a, z], dim=a.dim() - 2) for a, z in zip(buckets, ident)])


def _win_slice(buckets, lo: int, hi: int):
    return _map(lambda a: a.narrow(a.dim() - 2, lo, hi - lo), buckets)


def _butterfly_reduce_scatter(group, grids: list, mesh: Mesh, K2: int) -> list:
    """Hypercube reduce-scatter over the window axis with the group add:
    log2(D) steps, each exchanging half of the live window range. At step s
    shard d keeps the low half when (d // s) % 2 == 0, else the high half,
    sends the other half to shard d ^ s and adds the half it receives. Every
    send is staged from the grids before the step, before any add."""
    D = len(grids)
    if K2 % D:
        raise ValueError(f"{K2} windows do not split into {D} shards")
    width, s = K2, D >> 1
    while s >= 1:
        h = width // 2
        keep, send = [], []
        for d, B in enumerate(grids):
            low, high = _win_slice(B, 0, h), _win_slice(B, h, width)
            keep.append(low if (d // s) % 2 == 0 else high)
            send.append(high if (d // s) % 2 == 0 else low)
        recv = [_to(send[d ^ s], dev) for d, dev in enumerate(mesh.devices)]
        grids = []
        for d, dev in enumerate(mesh.devices):
            with _scope(dev):
                grids.append(group.add(keep[d], recv[d]))
        width, s = h, s >> 1
    return grids


def _reduce_scatter_windows(rg, grids: list, c: int, mesh: Mesh, K: int, L: int):
    """Reduce-scatter the bucket grids (planes (n, K, L)) over windows,
    reduce each shard's windows on its device, gather the window sums on the
    mesh's first device in window order and combine them there. Returns the
    point (planes (n, 1)) on mesh.devices[0]."""
    D = len(grids)
    K2 = -(-K // D) * D
    grids = [_pad_windows(rg, B, K, K2) for B in grids]
    if D > 1:
        grids = _butterfly_reduce_scatter(rg, grids, mesh, K2)
    Kloc, home = K2 // D, mesh.devices[0]
    sums = []
    for dev, B in zip(mesh.devices, grids):
        with _scope(dev):
            W = window_sums(rg, B, Kloc, L)  # planes (n, Kloc, 1)
        sums.append(_to(_map(lambda a: a.reshape(*a.shape[:-2], a.shape[-2]), W), home))
    W = type(sums[0])(*[torch.cat(planes, dim=-1) for planes in zip(*sums)])
    with _scope(home):
        return combine_windows(rg, W, c, K2)


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")


def msm_sharded(group, points: list, digits: list, c: int, mesh: Mesh, axis: str = "dp",
                window_chunk: int | None = None, reduce_group=None, to_reduce=None):
    """MSM over the shards of `shard_points`: each shard's bucket grid
    (`bucket_accumulate` with `group` and `window_chunk`, whose packed rows
    a packed group makes here from the shard's points), then the window
    reduce-scatter with `reduce_group` (default `group`) after `to_reduce`
    (the affine accumulation reduces in complete projective coordinates:
    reduce_group=ctx.adapter, to_reduce=ctx.aff_adapter.to_projective).
    `axis` must name the mesh's one axis. Returns a point of the reduce
    group (planes (n, 1)) on mesh.devices[0]."""
    _check_shards(mesh, points, digits)
    _check_axis(mesh, axis)
    rg = reduce_group if reduce_group is not None else group
    grids = []
    for dev, P, dg in zip(mesh.devices, points, digits):
        with _scope(dev):
            src = group.pack_rows(P) if hasattr(group, "add_packed") else P
            B, K, L = bucket_accumulate(group, src, dg, c, window_chunk)
            if to_reduce is not None:
                B = to_reduce(B)
        grids.append(B)
    return _reduce_scatter_windows(rg, grids, c, mesh, K, L)


def msm_full_sharded(ctx, points: list, scalar_limbs: list, c: int, mesh: Mesh, axis: str = "dp",
                     affine: bool = True, unsafe: bool = False, window_chunk: int | None = None):
    """The whole MSM over the shards of `shard_points` (AffineBatch points,
    (ns, N / D) scalar limbs each): per shard the GLV digits, the GLV
    expansion (`pack_rows_glv`, or `expand_points_glv` for the projective
    engine), the bucket accumulation of `WeierstrassMsm.msm_device_full`'s
    engine (affine, unsafe and window_chunk as there) and the move to
    projective coordinates; then the reduce-scatter in the complete
    projective group, each shard's window sums, the gather and the combine.
    ctx: WeierstrassMsm. Returns a ProjectiveBatch of one point on
    mesh.devices[0]."""
    _check_shards(mesh, points, scalar_limbs)
    _check_axis(mesh, axis)
    group = ctx.adapter
    if affine:
        group = ctx.aff_adapter_unsafe if unsafe else ctx.aff_adapter
    rg = ctx.adapter
    grids = []
    for dev, A, limbs in zip(mesh.devices, points, scalar_limbs):
        with _scope(dev):
            digits = ctx.digits_device(limbs, c)
            if affine:
                src = ctx.affine.pack_rows_glv(A)
            else:
                src = rg.from_points(ctx.expand_points_glv(A))
            B, K, L = bucket_accumulate(group, src, digits, c, window_chunk)
            if affine:
                B = group.to_projective(B)
        grids.append(B)
    return _reduce_scatter_windows(rg, grids, c, mesh, K, L)
