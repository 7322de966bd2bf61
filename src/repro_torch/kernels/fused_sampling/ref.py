"""Top-k / top-p filtering semantics in plain PyTorch: the canonical tiled
reduction, the monotone float bit keys, the decision predicates, the
sort-based oracle ``filter_logits_ref`` and the sort-free bisection
``filter_logits_bisect`` that the CUDA kernel (``csrc/sampling.cu``)
reproduces bit for bit. Counterpart of ``repro.kernels.fused_sampling.ref``
(and of ``ops._filter_logits_jnp`` for the bisection); see that module for
the semantics: ties at the k-th value are kept, the nucleus keeps every
value whose strictly-greater mass stays under ``T = top_p * Z``.

The port fixes one order for every float mass: inside each RED_TILE-lane
tile a halving tree ``x[:w/2] + x[w/2:]`` for w = 128 ... 2, across tiles
a strictly sequential left fold ``(((0 + p0) + p1) + ...)``. The JAX
package leaves the in-tile order to XLA, so the port matches it bit for bit
only where that choice does not move a threshold; the kernel and this
module match each other always.

Bit keys are held in int64 tensors masked to 32 bits (PyTorch has no
general uint32 arithmetic).
"""
from __future__ import annotations

import numpy as np
import torch

T_FLOOR = 1.1754943508222875e-38        # smallest normal float32
RED_TILE = 128
BISECT_STEPS = 32
TOP_KEY = 0xFFFFFFFE                     # keeps the uint32 midpoint exact
_MASK = 0xFFFFFFFF
_SIGN = 0x80000000


# ------------------------------------------------ canonical tiled reduction ---
def tile_partial_sums(x: torch.Tensor) -> torch.Tensor:
    """Per-tile sums [S, ceil(V / RED_TILE)] of ``x`` [S, V] (zero-padded on
    the right), each a halving tree over the tile's lanes."""
    s, v = x.shape
    pad = (-v) % RED_TILE
    if pad:
        x = torch.cat([x, x.new_zeros((s, pad))], dim=-1)
    x = x.reshape(s, -1, RED_TILE)
    w = RED_TILE
    while w > 1:
        x = x[..., :w // 2] + x[..., w // 2:]
        w //= 2
    return x[..., 0]


def fold_prefix(parts: torch.Tensor) -> torch.Tensor:
    """Inclusive strictly sequential left fold of partials [S, n] -> [S, n]
    in float32. Evaluated with numpy's ``add.accumulate`` on the host, which
    adds in index order (a device scan would reassociate); only the plain
    versions call it; the CUDA kernels fold on the card."""
    out = np.add.accumulate(parts.detach().float().cpu().numpy(), axis=1)
    return torch.from_numpy(out).to(parts.device)


def fold_partials(parts: torch.Tensor) -> torch.Tensor:
    """The canonical fold [S, n] -> [S]."""
    return fold_prefix(parts)[:, -1]


def tiled_row_sum(x: torch.Tensor) -> torch.Tensor:
    return fold_partials(tile_partial_sums(x))


# --------------------------------------------------------------- bit keys ----
def float_to_key(f: torch.Tensor) -> torch.Tensor:
    """float32 -> uint32 key (as int64), strictly monotone in the float
    order (-inf < ... < -0.0 < +0.0 < ... < +inf)."""
    b = f.float().contiguous().view(torch.int32).long() & _MASK
    return torch.where((b >> 31) != 0, (~b) & _MASK, b ^ _SIGN)


def key_to_float(k: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`float_to_key`."""
    b = torch.where((k >> 31) == 0, (~k) & _MASK, k ^ _SIGN)
    signed = torch.where(b >= _SIGN, b - (1 << 32), b)
    return signed.to(torch.int32).view(torch.float32)


# ------------------------------------------------- canonical decision math ----
def softmax_mass_stats(lg_k: torch.Tensor):
    """``(U, Z)``: ``U = exp(lg_k - rowmax)`` (0 at masked entries) and its
    canonical row sum."""
    m = lg_k.max(dim=-1).values
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    u = torch.exp(lg_k - safe_m[:, None])
    return u, tiled_row_sum(u)


def nucleus_target(top_p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(top_p.float() * z, T_FLOOR)


def strict_greater_mass(lg_k, u, v):
    """SG(v) [S]: mass of the entries strictly above the candidate value."""
    return tiled_row_sum(torch.where(lg_k > v[:, None], u, torch.zeros_like(u)))


def mass_above_key(keys_k, u, mid):
    """SG evaluated in key space: mass of entries whose key is above mid."""
    return tiled_row_sum(torch.where(keys_k > mid[:, None], u,
                                     torch.zeros_like(u)))


def count_ge_key(keys, mid):
    return (keys >= mid[:, None]).sum(dim=-1)


def _effective_k(top_k: torch.Tensor, v: int) -> torch.Tensor:
    tk = top_k.long()
    return torch.where(tk <= 0, torch.full_like(tk, v), tk.clamp_max(v))


# ----------------------------------------------------------- sort-based ref ---
def filter_logits_ref(lg: torch.Tensor, top_k: torch.Tensor,
                      top_p: torch.Tensor) -> torch.Tensor:
    """Top-k then nucleus top-p masking of ``lg`` [S, V] through one
    descending sort and a bisection over its ranks; dropped entries -inf."""
    s, v = lg.shape
    lg = lg.float()
    desc = torch.sort(lg, dim=-1, descending=True).values
    k = _effective_k(top_k.to(lg.device), v)
    kth = desc.gather(1, (k - 1)[:, None])[:, 0]
    neg = torch.full_like(lg, float("-inf"))
    lg_k = torch.where(lg < kth[:, None], neg, lg)
    desc_k = torch.where(desc < kth[:, None], neg, desc)
    u, z = softmax_mass_stats(lg_k)
    t = nucleus_target(top_p.to(lg.device), z)
    lo = torch.zeros((s,), dtype=torch.int64, device=lg.device)
    hi = torch.full((s,), v - 1, dtype=torch.int64, device=lg.device)
    for _ in range(max(1, (v - 1).bit_length())):
        mid = lo + ((hi - lo + 1) >> 1)
        cand = desc_k.gather(1, mid[:, None])[:, 0]
        ok = strict_greater_mass(lg_k, u, cand) < t
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    th = desc_k.gather(1, lo[:, None])[:, 0]
    th = torch.where(top_p.to(lg.device) >= 1.0,
                     torch.full_like(th, float("-inf")), th)
    return torch.where(lg_k < th[:, None], neg, lg_k)


# ------------------------------------------------------ sort-free bisection ---
def filter_logits_bisect(lg: torch.Tensor, top_k: torch.Tensor,
                         top_p: torch.Tensor) -> torch.Tensor:
    """The plain version of the CUDA filter kernel: a 32-step count
    bisection for top-k and a 32-step mass bisection for top-p over the bit
    keys, bitwise equal to :func:`filter_logits_ref`."""
    s, v = lg.shape
    lg = lg.float()
    dev = lg.device
    keys = float_to_key(lg)
    k = _effective_k(top_k.to(dev), v)
    lo = torch.zeros((s,), dtype=torch.int64, device=dev)
    hi = torch.full((s,), TOP_KEY, dtype=torch.int64, device=dev)
    for _ in range(BISECT_STEPS):
        mid = lo + ((hi - lo + 1) >> 1)
        ok = count_ge_key(keys, mid) >= k
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    kth = key_to_float(lo)
    neg = torch.full_like(lg, float("-inf"))
    lg_k = torch.where(lg < kth[:, None], neg, lg)

    u, z = softmax_mass_stats(lg_k)
    t = nucleus_target(top_p.to(dev), z)
    keys_k = float_to_key(lg_k)
    lo = torch.zeros((s,), dtype=torch.int64, device=dev)
    hi = torch.full((s,), TOP_KEY, dtype=torch.int64, device=dev)
    for _ in range(BISECT_STEPS):
        mid = lo + ((hi - lo) >> 1)
        ok = mass_above_key(keys_k, u, mid) < t
        lo, hi = torch.where(ok, lo, mid + 1), torch.where(ok, mid, hi)
    th = key_to_float(hi)
    th = torch.where(top_p.to(dev) >= 1.0,
                     torch.full_like(th, float("-inf")), th)
    return torch.where(lg_k < th[:, None], neg, lg_k)


# ------------------------------- the CUDA kernel's search, modelled on the CPU ---
RADIX_BITS = 8
CANDIDATES = 16                          # the kernel's nucleus candidates a sweep


def kth_key_radix(keys: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The k-th largest key of each row of ``keys`` [S, V] (uint32 values in
    int64), ``k`` [S] in [1, V]: four passes of 8-bit digits from the top,
    each a 256-bin count of the keys that match the digits found so far.
    Counts are integers, so this is exactly the count bisection's ``lo``
    (clamped at ``TOP_KEY`` as the bisection's range is)."""
    s, _ = keys.shape
    prefix = torch.zeros((s,), dtype=torch.int64, device=keys.device)
    want = k.long().clone()
    bins = 1 << RADIX_BITS
    for shift in range(32 - RADIX_BITS, -1, -RADIX_BITS):
        top = shift + RADIX_BITS
        match = (keys >> top) == (prefix >> top)[:, None]
        digit = (keys >> shift) & (bins - 1)
        hist = torch.zeros((s, bins), dtype=torch.int64, device=keys.device)
        hist.scatter_add_(1, digit, match.long())
        at_or_above = hist.flip(1).cumsum(1).flip(1)     # keys with digit >= d
        d = (at_or_above >= want[:, None]).sum(1) - 1    # the largest such d
        above = at_or_above.gather(1, d[:, None])[:, 0] \
            - hist.gather(1, d[:, None])[:, 0]
        prefix = prefix | (d << shift)
        want = want - above
    return prefix.clamp_max(TOP_KEY)


def nucleus_candidates(plo: torch.Tensor, phi: torch.Tensor,
                       cands: int) -> torch.Tensor:
    """[S, cands] keys spread over [plo, phi - 1]: plo + floor(j (phi - plo)
    / (cands + 1)) for j = 1 .. cands, every key of the range once it holds
    ``cands`` or fewer."""
    j = torch.arange(1, cands + 1, dtype=torch.int64, device=plo.device)
    return plo[:, None] + ((phi - plo)[:, None] * j) // (cands + 1)


def _sweep_update(plo, phi, cand, ok):
    """New bounds of a search from candidates ``cand`` [S, C] (ascending)
    and ``ok`` = SG(cand) < t: the smallest ok candidate, one past the
    largest that is not."""
    big = torch.full_like(cand, TOP_KEY + 1)
    first_ok = torch.where(ok, cand, big).amin(1)
    last_bad = torch.where(ok, torch.full_like(cand, -1), cand).amax(1)
    live = plo < phi
    return (torch.where(live, torch.maximum(plo, last_bad + 1), plo),
            torch.where(live, torch.minimum(phi, first_ok), phi))


FIXED_ONE = 2.0 ** 32       # the estimate's fixed point: a mass of 1


def estimate_key(keys_k: torch.Tensor, u: torch.Tensor, t: torch.Tensor,
                 scale: float = 1.0) -> torch.Tensor:
    """An estimate of the nucleus key: the smallest key whose
    strictly-greater mass stays under ``t``, with masses in fixed point
    (u 2^32 rounded, times ``scale`` first, which the tests use to make the
    estimate wrong) summed exactly as integers, so the kernel gets these
    very bits in any order. Four 8-bit passes from the top, each a 256-bin
    sum of the masses of the keys that match the digits found so far; the
    digit is the smallest whose mass above is at most t 2^32 rounded (at
    most, so that a t under one unit still finds the top key with mass)."""
    s, _ = keys_k.shape
    prefix = torch.zeros((s,), dtype=torch.int64, device=keys_k.device)
    above = torch.zeros((s,), dtype=torch.int64, device=keys_k.device)
    w = torch.round((u.float() * scale).double() * FIXED_ONE).long()
    tt = torch.round(t.float().double() * FIXED_ONE).long()
    bins = 1 << RADIX_BITS
    for shift in range(32 - RADIX_BITS, -1, -RADIX_BITS):
        match = (((keys_k ^ prefix[:, None]) >> shift) >> RADIX_BITS) == 0
        digit = (keys_k >> shift) & (bins - 1)
        m = torch.zeros((s, bins), dtype=torch.int64, device=keys_k.device)
        m.scatter_add_(1, digit, torch.where(match, w, 0))
        sg = above[:, None] + m.flip(1).cumsum(1).flip(1) - m   # above d
        d = (sg <= tt[:, None]).long().argmax(1)
        above = sg.gather(1, d[:, None])[:, 0]
        prefix = prefix | (d << shift)
    return prefix.clamp_max(TOP_KEY)


def first_candidates(key: torch.Tensor, cands: int) -> torch.Tensor:
    """[S, cands] keys around an estimate: key - 4^i (i = cands/2 - 1 ...
    0) below it, key + 4^i - 1 (i = 0 ...) from it up, clamped to [0,
    TOP_KEY]: the first exact sweep ends the search when the estimate is
    right (key - 1 fails, key passes) and brackets it within a factor 4 of
    its distance when it is not."""
    half = cands // 2
    low = torch.tensor([4 ** i for i in range(half - 1, -1, -1)],
                       dtype=torch.int64, device=key.device)
    high = torch.tensor([4 ** i - 1 for i in range(cands - half)],
                        dtype=torch.int64, device=key.device)
    return torch.cat([(key[:, None] - low).clamp_min(0),
                      (key[:, None] + high).clamp_max(TOP_KEY)], dim=1)


def nucleus_key_search(keys_k: torch.Tensor, u: torch.Tensor,
                       t: torch.Tensor, cands: int = CANDIDATES,
                       estimate_scale: float = 1.0) -> torch.Tensor:
    """The smallest key K in [0, TOP_KEY] whose strictly-greater mass
    SG(K) (canonical order) stays under ``t``, found as the CUDA kernel
    finds it: :func:`estimate_key` (``estimate_scale`` lets the tests make
    it wrong), then exact sweeps, each candidate's SG by its own per-tile
    halving trees and its own left fold, the first on
    :func:`first_candidates` of the estimate, each later one on
    :func:`retry_candidates` of what is left, until one key is left. The estimate only places candidates; SG is monotone in K, so
    the result is exactly the mass bisection's ``hi``, however wrong the
    estimate."""
    if cands < 2:
        raise ValueError(f"the search needs 2 candidates or more, got {cands}")
    s, v = keys_k.shape
    lo = torch.zeros((s,), dtype=torch.int64, device=keys_k.device)
    hi = torch.full((s,), TOP_KEY, dtype=torch.int64, device=keys_k.device)
    cand = first_candidates(estimate_key(keys_k, u, t, estimate_scale), cands)
    while True:
        sel = keys_k[:, None, :] > cand[:, :, None]             # [S, C, V]
        masses = torch.where(sel, u[:, None, :], torch.zeros_like(
            sel, dtype=u.dtype))
        sg = tiled_row_sum(masses.reshape(s * cands, v)).reshape(s, cands)
        lo, hi = _sweep_update(lo, hi, cand, sg < t[:, None])
        if not bool((lo < hi).any()):
            return hi
        cand = retry_candidates(keys_k, u, lo, hi, cands)


def retry_candidates(keys_k, u, lo, hi, cands):
    """[S, cands] keys for an exact sweep after one that did not end: the
    threshold is a key with mass in [lo, hi], most often the first, kappa
    (the smallest such key): kappa - 1 and kappa, then cands - 2 keys spread
    over [kappa + 1, hi]."""
    present = (u > 0) & (keys_k >= lo[:, None]) & (keys_k <= hi[:, None])
    kappa = torch.where(present, keys_k, torch.full_like(keys_k, 2 ** 32)
                        ).amin(1)
    kappa = torch.minimum(kappa, hi)
    lo2 = torch.minimum(kappa + 1, hi)
    return torch.cat([(kappa - 1).clamp_min(0)[:, None], kappa[:, None],
                      nucleus_candidates(lo2, hi, cands - 2)], dim=1)


def filter_logits_search(lg: torch.Tensor, top_k: torch.Tensor,
                         top_p: torch.Tensor, cands: int = CANDIDATES,
                         estimate_scale: float = 1.0) -> torch.Tensor:
    """The CUDA filter kernel's search, step for step: top-k by radix select
    (the minimum key when k >= V), the masses ``u`` once, then the nucleus
    by :func:`nucleus_key_search`. Bitwise equal to
    :func:`filter_logits_bisect`; only the tests call it."""
    s, v = lg.shape
    lg = lg.float()
    dev = lg.device
    keys = float_to_key(lg)
    k = _effective_k(top_k.to(dev), v)
    kth_key = torch.where(k >= v, keys.amin(1).clamp_max(TOP_KEY),
                          kth_key_radix(keys, k.clamp_min(1)))
    kth = key_to_float(kth_key)
    neg = torch.full_like(lg, float("-inf"))
    lg_k = torch.where(lg < kth[:, None], neg, lg)
    th = torch.full((s,), float("-inf"), device=dev)
    rows = (top_p.to(dev) < 1.0).nonzero()[:, 0]    # top_p >= 1: no search
    if len(rows):
        u, z = softmax_mass_stats(lg_k[rows])
        t = nucleus_target(top_p.to(dev)[rows], z)
        th[rows] = key_to_float(nucleus_key_search(
            float_to_key(lg_k[rows]), u, t, cands, estimate_scale))
    return torch.where(lg_k < th[:, None], neg, lg_k)
