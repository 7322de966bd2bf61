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
