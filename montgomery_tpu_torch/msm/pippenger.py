"""Single-device Pippenger MSM engine (sort + pair-halving + two-level
bucket reduction + window combine).

Counterpart of `montgomery_tpu/msm/pippenger.py`, with its two accumulation
paths: the tree-of-planes path of the complete projective group
(`ProjectiveAdapter`) and the packed path of any group with `add_packed`
(`AffineAccumAdapter`, whose buckets leave as affine points for a projective
reduction, and `EdwardsAdapter`, whose reduction stays in the same group):
one packed array per round, an 8-way super-round first where the buckets are
full enough. Point batches are NamedTuples of planes (ProjectiveBatch,
AffineBatch, EdwardsBatch); the engine rebuilds whatever type it is given.
Both paths:

- Each window's (bucket, point, sign) keys are sorted with one `torch.sort`
  of int64 keys; bucket counts come from `torch.bincount`.
- Pair-halving rounds add adjacent elements of every bucket run with one
  batched group add; output slots map to buckets by `torch.searchsorted`.
  The first rounds shrink by static sizes, the tail repeats at a fixed size
  until every bucket holds at most one element (one `.item()` per round).
- The bucket sums W_k = sum_j (j+1) B_{k,j} use row and column trees and
  suffix scans; the complete projective and the Twisted Edwards groups
  combine the windows in one Horner launch each (`combine`);
  `combine_halving`, log2(K) levels of one `double_n` launch and one add
  each, serves any group without one.
- `window_chunk` accumulates a few windows at a time, as the JAX package's
  scan over window chunks does: the same launches per chunk, less memory.
"""

from __future__ import annotations

import torch

from ..curves.projective import ProjectiveBatch


def window_size(log2_n: int) -> int:
    """Window size c for 2^log2_n points. The table is montgomery_tpu's
    (swept on its original hardware, not on this port's); sizes outside it
    use max(log2_n - 1, 1)."""
    table = {
        10: 9, 11: 9, 12: 10, 13: 10, 14: 11, 15: 11,
        16: 11, 17: 12, 18: 12, 19: 13, 20: 13, 21: 14,
    }
    c = table.get(log2_n, max(log2_n - 1, 1))
    return max(1, min(c, 16))


def _map(fn, P):
    return type(P)(*[fn(a) for a in P])


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


def _next_pow2(m: int) -> int:
    return 1 << max(0, (m - 1).bit_length())


def _pad_pow2(group, P, size: int, batch_shape):
    """Pad the trailing axis from `size` to the next power of two with zeros."""
    target = _next_pow2(size)
    if target == size:
        return P
    ident = group.zero_like((*batch_shape, target - size), P.X.device)
    return type(P)(*[torch.cat([a, z], -1) for a, z in zip(P, ident)])


def _round_sizes(M0: int, G: int, max_python_rounds: int = 8):
    """Sizes of the shrinking pair-halving rounds: a round maps M elements
    to at most (M + #buckets) / 2 survivors."""
    sizes = [M0]
    while len(sizes) <= max_python_rounds:
        M = sizes[-1]
        nxt = min(M, (M + min(G, M)) // 2 + 1)
        if nxt >= M * 0.75:
            break
        sizes.append(nxt)
    return sizes


def msm_digits(group, points, digits: torch.Tensor, c: int, window_chunk: int | None = None):
    """sum_i s_i P_i from signed digits (K, N) in [-2^(c-1), 2^(c-1)];
    returns a batch of the group's type with trailing shape (1,). `points`
    is the group's point batch, or its packed rows for a packed group;
    `window_chunk` as in `bucket_accumulate`."""
    buckets, K_pad, L = bucket_accumulate(group, points, digits, c, window_chunk)
    return reduce_buckets(group, buckets, c, K_pad, L)


def msm_digits_affine(aff_group, proj_group, points, digits: torch.Tensor, c: int,
                      window_chunk: int | None = None, prepacked: bool = False) -> ProjectiveBatch:
    """MSM with batched-affine accumulation (`AffineAccumAdapter`); the
    bucket reduction runs in projective coordinates (`proj_group`).
    points: an AffineBatch, packed here with `pack_rows`, or with prepacked
    its packed rows (2n+1, N) (a fused packing kernel's, `pack_rows_glv`)."""
    rows = points if prepacked else aff_group.pack_rows(points)
    buckets, K_pad, L = bucket_accumulate(aff_group, rows, digits, c, window_chunk)
    return reduce_buckets(proj_group, aff_group.to_projective(buckets), c, K_pad, L)


def _sort_slots(digits: torch.Tensor, L: int):
    """Per-window sort of (bucket, point, sign) keys. Returns the sorted
    (point << 1 | sign) values flattened over windows, and each bucket slot's
    count and start; window k's bucket j+1 is slot k (L+1) + j, and slot
    k (L+1) + L holds the zero digits, which never pair (count 0)."""
    K, N = digits.shape
    dev = digits.device
    nb = max((N - 1).bit_length(), 1)
    d = digits.to(torch.int64)
    b = d.abs()
    loc = torch.where(b > 0, b - 1, L)
    idx = torch.arange(N, device=dev)
    key = (loc << (nb + 1)) | (idx << 1) | (d < 0).to(torch.int64)
    key_s, _ = torch.sort(key, dim=1)
    perm_flat = (key_s & ((1 << (nb + 1)) - 1)).reshape(-1)
    Gd = K * (L + 1)
    slot = (loc + torch.arange(K, device=dev)[:, None] * (L + 1)).reshape(-1)
    counts = torch.bincount(slot, minlength=Gd)
    starts = _excl_cumsum(counts)
    slot_loc = torch.arange(Gd, device=dev) % (L + 1)
    return perm_flat, torch.where(slot_loc == L, 0, counts), starts


def _fan_in(counts, starts, size_out: int, F: int):
    """A round that merges up to F adjacent elements of every bucket run:
    for each output slot j, the position of its first source element and
    the end of its bucket's run; and the buckets' new counts and starts."""
    new_counts = (counts + F - 1) // F
    new_starts = _excl_cumsum(new_counts)
    j = torch.arange(size_out, device=counts.device)
    bid = (torch.searchsorted(new_starts, j, right=True) - 1).clamp(0, counts.numel() - 1)
    src0 = F * j + (starts - F * new_starts)[bid]
    return src0, (starts + counts)[bid], new_counts, new_starts


def _bucket_slots(counts, starts, K: int, L: int):
    """(valid, position) of every bucket (window k, bucket j+1 at k L + j)."""
    dev = counts.device
    gid = (torch.arange(K, device=dev)[:, None] * (L + 1)
           + torch.arange(L, device=dev)[None, :]).reshape(-1)
    return counts[gid] == 1, starts[gid]


def bucket_accumulate(group, points, digits: torch.Tensor, c: int,
                      window_chunk: int | None = None):
    """Sort and pair-halving bucket accumulation. Returns (buckets with
    planes (n, K_pad, L), K_pad, L); position j of a window is bucket j+1. A
    group with `add_packed` takes the packed path, with `points` its packed
    rows (the JAX package packs inside; here the caller does, so a fused
    packing kernel can feed it). Without `window_chunk` all K windows
    accumulate at once; with it, KC = min(window_chunk, K) windows at a time
    (less memory per round), the K windows padded with zero-digit windows to
    K_pad = ceil(K / KC) KC, whose buckets are empty, and the chunks' bucket
    grids joined along the window axis (the JAX package's meaning)."""
    K, N = digits.shape
    KC = min(window_chunk or K, K)
    K_pad = -(-K // KC) * KC
    if K_pad != K:
        digits = torch.cat([digits, digits.new_zeros((K_pad - K, N))])
    if hasattr(group, "add_packed"):
        group.rounds.clear()
        accumulate = _accumulate_packed
    else:
        accumulate = _accumulate_planes
    grids = [accumulate(group, points, digits[k:k + KC], c) for k in range(0, K_pad, KC)]
    if len(grids) > 1:
        grids = [type(grids[0])(*[torch.cat(planes, dim=-2) for planes in zip(*grids)])]
    return grids[0], K_pad, 1 << (c - 1)


def _accumulate_planes(group, points, digits: torch.Tensor, c: int):
    """Tree-of-planes path of `bucket_accumulate` (the complete projective
    group): all windows of `digits` at once; returns the bucket grid with
    planes (n, K, L)."""
    K, N = digits.shape
    L = 1 << (c - 1)
    dev = digits.device
    M0 = K * N
    sizes = _round_sizes(M0, K * L)
    perm_flat, counts, starts = _sort_slots(digits, L)
    # points and their negations: round 0 reads both through the sort order
    negY = group.f.neg(points.Y)

    def pair_round(counts, starts, size_out, read):
        src0, end, new_counts, new_starts = _fan_in(counts, starts, size_out, 2)
        src = src0.clamp(min=0)
        has_pair = (src + 1) < end
        A = read(src)
        B = read(torch.where(has_pair, src + 1, src))
        return group.select(has_pair, group.add(A, B), A), new_counts, new_starts

    def read_points(src):
        # round 0 reads the points through the sort order, negated by sign
        pv = perm_flat[src.clamp(max=M0 - 1)]
        i = pv >> 1
        Y = torch.where((pv & 1).bool()[None], negY[:, i], points.Y[:, i])
        return ProjectiveBatch(points.X[:, i], Y, points.Z[:, i])

    def read_cur(src, P_ref):
        return group.gather(P_ref, src.clamp(max=P_ref.count - 1))

    size1 = sizes[1] if len(sizes) > 1 else M0
    P_cur, counts, starts = pair_round(counts, starts, size1, read_points)
    for size_out in sizes[2:]:
        P_cur, counts, starts = pair_round(
            counts, starts, size_out, lambda s, P=P_cur: read_cur(s, P))
    while int(counts.max()) > 1:  # tail rounds at a fixed size
        P_cur, counts, starts = pair_round(
            counts, starts, sizes[-1], lambda s, P=P_cur: read_cur(s, P))

    valid, pos = _bucket_slots(counts, starts, K, L)
    Bpt = group.gather(P_cur, pos.clamp(max=P_cur.count - 1))
    Bpt = group.select(valid, Bpt, group.zero_like((K * L,), dev))
    return _map(lambda a: a.reshape(a.shape[0], K, L), Bpt)


def _bitrev_order(F: int) -> list[int]:
    """0..F-1 in bit-reversed order: with the operand blocks laid out so,
    every level's pairs are the two contiguous halves of the level before."""
    lv = F.bit_length() - 1
    return sorted(range(F), key=lambda t: int(f"{t:0{lv}b}"[::-1], 2))


def _accumulate_packed(group, rows: torch.Tensor, digits: torch.Tensor, c: int):
    """Packed path of `bucket_accumulate` (montgomery_tpu's, :136-395), all
    windows of `digits` at once:
    points stay one (2n+1, M) array, so a round is one column gather and
    one `add_packed` (pre kernel, shared batch inversion, post kernel) that
    folds in the signs and the pass-through of unpaired lanes. Once a window
    holds 64 or more points per bucket, the first round is an 8-way
    super-round: ONE gather of its 8 operand blocks, then three add levels
    on contiguous halves. The rounds are recorded in `group.rounds` as
    (kind, fan-in, output width), kind "super", "pair" (a shrinking round)
    or "tail" (a round of the fixed-width loop), appended chunk after chunk.
    Returns the batch that `group.buckets_from_packed` gives, each plane
    reshaped from (..., K L) to (..., K, L)."""
    K, N = digits.shape
    L = 1 << (c - 1)
    dev = digits.device
    G = K * L
    M0 = K * N
    perm_flat, counts, starts = _sort_slots(digits, L)

    def read_sorted(pos):
        # round-0 operands: the points through the sort order, and their signs
        pv = perm_flat[pos.clamp(0, M0 - 1)]
        return rows.index_select(1, pv >> 1), (pv & 1).to(torch.int32)[None]

    def pair_round(P_cur, counts, starts, size_out, kind="pair"):
        src0, end, new_counts, new_starts = _fan_in(counts, starts, size_out, 2)
        src = src0.clamp(min=0)
        has_pair = (src + 1) < end
        both = torch.cat([src, torch.where(has_pair, src + 1, src)])
        if P_cur is None:
            AB, sg = read_sorted(both)
            sA, sB = sg[:, :size_out], sg[:, size_out:]
        else:
            AB = P_cur.index_select(1, both.clamp(max=P_cur.shape[1] - 1))
            sA = sB = torch.zeros((1, size_out), dtype=torch.int32, device=dev)
        hp = has_pair.to(torch.int32)[None]
        group.rounds.append((kind, 2, size_out))
        out = group.add_packed(AB[:, :size_out], AB[:, size_out:], sA, sB, hp)
        return out, new_counts, new_starts

    def super_round(counts, starts, size_out, F):
        # output slot j merges run elements [src0, src0 + F); r of them exist.
        # Level pairs (first t, second t') merge iff r > t'; a pass-through
        # keeps the first operand, whose block id the survivor carries.
        src0, end, new_counts, new_starts = _fan_in(counts, starts, size_out, F)
        r = end - src0
        blocks = _bitrev_order(F)
        C, sg = read_sorted(torch.cat([src0 + t for t in blocks]))
        half = (F // 2) * size_out
        sA, sB = sg[:, :half], sg[:, half:]
        group.rounds.append(("super", F, size_out))
        while len(blocks) > 1:
            nblk = len(blocks) // 2
            hp = torch.cat([r > t2 for t2 in blocks[nblk:]]).to(torch.int32)[None]
            w = nblk * size_out
            if nblk < F // 2:
                sA = sB = torch.zeros((1, w), dtype=torch.int32, device=dev)
            C = group.add_packed(C[:, :w], C[:, w:], sA, sB, hp)
            blocks = blocks[:nblk]
        return C, new_counts, new_starts

    # the 8-way first round pays G extra output slots per level; it wins once
    # the points per bucket make that negligible (montgomery_tpu's threshold)
    if M0 >= 64 * G:
        size_s = M0 // 8 + G + 2
        P_cur, counts, starts = super_round(counts, starts, size_s, 8)
        sizes = _round_sizes(size_s, G)
    else:
        sizes = _round_sizes(M0, G)
        sizes = [sizes[1] if len(sizes) > 1 else M0, *sizes[2:]]
        P_cur, counts, starts = pair_round(None, counts, starts, sizes[0])
    for size_out in sizes[1:]:
        P_cur, counts, starts = pair_round(P_cur, counts, starts, size_out)
    while int(counts.max()) > 1:  # tail rounds at a fixed size
        P_cur, counts, starts = pair_round(P_cur, counts, starts, sizes[-1], "tail")

    valid, pos = _bucket_slots(counts, starts, K, L)
    B = group.buckets_from_packed(P_cur.index_select(1, pos.clamp(max=P_cur.shape[1] - 1)), valid)
    return _map(lambda a: a.reshape(*a.shape[:-1], K, L), B)


def _suffix_scan(group, P, size: int, batch_shape):
    """Hillis-Steele suffix sums over the trailing axis; shifted-in
    elements are the group identity."""
    dev = P.X.device
    s = 1
    while s < size:
        Psh = _map(lambda a, d=s: torch.cat([a[..., d:], torch.zeros_like(a[..., :d])], -1), P)
        keep = torch.arange(size, device=dev) + s < size
        Psh = group.select(keep, Psh, group.zero_like((*batch_shape, size), dev))
        P = group.add(P, Psh)
        s <<= 1
    return P


def _tree_reduce_axis(group, P, size: int, axis_from_end: int):
    """Log-depth pairwise sum over an axis counted from the end of the batch
    axes (0 = last). `size` must be a power of two."""
    m = size
    while m > 1:
        h = m // 2
        lo = _map(lambda a, h=h: a.narrow(a.dim() - 1 - axis_from_end, 0, h), P)
        hi = _map(lambda a, h=h: a.narrow(a.dim() - 1 - axis_from_end, h, h), P)
        P = group.add(lo, hi)
        m = h
    return P


def reduce_buckets(group, buckets, c: int, K: int, L: int):
    """Bucket reduction and window combine; buckets planes (n, K, L)."""
    W = window_sums(group, buckets, K, L)
    W = _map(lambda a: a.reshape(a.shape[0], K), W)
    return combine_windows(group, W, c, K)


def window_sums(group, buckets, K: int, L: int):
    """W_k = sum_j (j+1) B_{k,j} with j = u S + v:
    S sum_u u R_u + sum_v (v+1) C_v, where R_u are the row sums and C_v the
    column sums of the (U, S) bucket grid. Returns planes (n, K, 1)."""
    dev = buckets.X.device
    log2L = max(L.bit_length() - 1, 0)
    log2S = log2L // 2
    S = 1 << log2S
    U = L // S
    n = group.f.n
    B4 = _map(lambda a: a.reshape(n, K, U, S), buckets)
    R = _tree_reduce_axis(group, B4, S, axis_from_end=0)
    R = _map(lambda a: a.reshape(n, K, U), R)
    Cs = _tree_reduce_axis(group, B4, U, axis_from_end=1)
    Cs = _map(lambda a: a.reshape(n, K, S), Cs)
    if U > 1:
        Rsuf = _suffix_scan(group, R, U, (K,))
        Rsuf = _map(lambda a: a[..., 1:U], Rsuf)
        high = _tree_reduce_axis(group, _pad_pow2(group, Rsuf, U - 1, (K,)),
                                 _next_pow2(U - 1), axis_from_end=0)
        high = group.double_n(high, log2S)
    else:
        high = group.zero_like((K, 1), dev)
    Csuf = _suffix_scan(group, Cs, S, (K,))
    low = _tree_reduce_axis(group, Csuf, S, axis_from_end=0)
    return group.add(high, low)


def combine_windows(group, W, c: int, K: int):
    """S = sum_k 2^(ck) W_k, W planes (n, K): the group's one-launch Horner
    combine where it has one (`combine`: the complete projective and the
    Twisted Edwards groups), else `combine_halving`."""
    if hasattr(group, "combine"):
        return group.combine(W, c)
    return combine_halving(group, W, c, K)


def combine_halving(group, W, c: int, K: int):
    """S = sum_k 2^(ck) W_k by halves: W_i += 2^(c h) W_{i+h}, one double_n
    launch and one add per level (the JAX package's log-depth combine, kept
    for groups without `combine` and as the one-launch combines'
    comparison). W planes (n, K)."""
    K2 = _next_pow2(K)
    if K2 != K:
        ident = group.zero_like((K2 - K,), W.X.device)
        W = type(W)(*[torch.cat([a, z], -1) for a, z in zip(W, ident)])
    m = K2
    while m > 1:
        h = m // 2
        top = group.double_n(_map(lambda a: a[..., h:m], W), c * h)
        W = group.add(_map(lambda a: a[..., :h], W), top)
        m = h
    return W
