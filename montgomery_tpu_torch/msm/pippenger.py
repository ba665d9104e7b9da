"""Single-device Pippenger MSM engine (sort + pair-halving + two-level
bucket reduction + log-depth window combine), tree-of-planes path.

Counterpart of `montgomery_tpu/msm/pippenger.py` for the complete projective
group (`ProjectiveAdapter`):

- Each window's (bucket, point, sign) keys are sorted with one `torch.sort`
  of int64 keys; bucket counts come from `torch.bincount`.
- Pair-halving rounds add adjacent elements of every bucket run with one
  batched group add; output slots map to buckets by `torch.searchsorted`.
  The first rounds shrink by static sizes, the tail repeats at a fixed size
  until every bucket holds at most one element (one `.item()` per round).
- The bucket sums W_k = sum_j (j+1) B_{k,j} use row and column trees and
  suffix scans; windows combine in log2(K) levels of one `double_n` launch
  and one add each.
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


def _map(fn, P: ProjectiveBatch) -> ProjectiveBatch:
    return ProjectiveBatch(*[fn(a) for a in P])


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
    return ProjectiveBatch(*[torch.cat([a, z], -1) for a, z in zip(P, ident)])


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


def msm_digits(group, points: ProjectiveBatch, digits: torch.Tensor, c: int) -> ProjectiveBatch:
    """sum_i s_i P_i from signed digits (K, N) in [-2^(c-1), 2^(c-1)];
    returns a batch with trailing shape (1,)."""
    buckets, K, L = bucket_accumulate(group, points, digits, c)
    return reduce_buckets(group, buckets, c, K, L)


def bucket_accumulate(group, points: ProjectiveBatch, digits: torch.Tensor, c: int):
    """Sort and pair-halving bucket accumulation over all K windows at
    once. Returns (buckets with planes (n, K, L), K, L); position j of a
    window is bucket j+1."""
    K, N = digits.shape
    L = 1 << (c - 1)
    dev = digits.device

    G = K * L  # live buckets
    Gd = K * (L + 1)  # slots: + one dead slot per window for zero digits
    M0 = K * N
    sizes = _round_sizes(M0, G)
    nb = max((N - 1).bit_length(), 1)
    slot_loc = torch.arange(Gd, device=dev) % (L + 1)
    # points and their negations: round 0 reads both through the sort order
    negY = group.f.neg(points.Y)

    def pair_indices(counts, starts, size_out):
        new_counts = (counts + 1) // 2
        new_starts = _excl_cumsum(new_counts)
        ends = starts + counts
        delta = starts - 2 * new_starts
        j = torch.arange(size_out, device=dev)
        bid = (torch.searchsorted(new_starts, j, right=True) - 1).clamp(0, Gd - 1)
        src = (2 * j + delta[bid]).clamp(min=0)
        has_pair = (src + 1) < ends[bid]
        return src, has_pair, new_counts, new_starts

    def pair_round(counts, starts, size_out, read):
        src, has_pair, new_counts, new_starts = pair_indices(counts, starts, size_out)
        A = read(src)
        B = read(torch.where(has_pair, src + 1, src))
        P_new = group.select(has_pair, group.add(A, B), A)
        return P_new, new_counts, new_starts

    d = digits.to(torch.int64)
    b = d.abs()
    loc = torch.where(b > 0, b - 1, L)
    idx = torch.arange(N, device=dev)
    key = (loc << (nb + 1)) | (idx << 1) | (d < 0).to(torch.int64)
    key_s, _ = torch.sort(key, dim=1)
    perm_flat = (key_s & ((1 << (nb + 1)) - 1)).reshape(-1)
    slot = (loc + torch.arange(K, device=dev)[:, None] * (L + 1)).reshape(-1)
    counts = torch.bincount(slot, minlength=Gd)
    starts = _excl_cumsum(counts)
    counts = torch.where(slot_loc == L, 0, counts)  # dead slots never pair

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

    gid = (torch.arange(K, device=dev)[:, None] * (L + 1)
           + torch.arange(L, device=dev)[None, :]).reshape(-1)
    valid = counts[gid] == 1
    Bpt = group.gather(P_cur, starts[gid].clamp(max=P_cur.count - 1))
    Bpt = group.select(valid, Bpt, group.zero_like((K * L,), dev))
    return _map(lambda a: a.reshape(a.shape[0], K, L), Bpt), K, L


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
    """S = sum_k 2^(ck) W_k by halves: W_i += 2^(c h) W_{i+h}, one double_n
    launch and one add per level. W planes (n, K)."""
    K2 = _next_pow2(K)
    if K2 != K:
        ident = group.zero_like((K2 - K,), W.X.device)
        W = ProjectiveBatch(*[torch.cat([a, z], -1) for a, z in zip(W, ident)])
    m = K2
    while m > 1:
        h = m // 2
        top = group.double_n(_map(lambda a: a[..., h:m], W), c * h)
        W = group.add(_map(lambda a: a[..., :h], W), top)
        m = h
    return W
