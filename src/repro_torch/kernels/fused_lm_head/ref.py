"""The per-row draw uniforms, the canonical inverse-CDF token draw and the
fused LM head's plain version. Counterpart of
``repro.kernels.fused_lm_head.ref`` (``row_uniforms``, ``pad_tiles``,
``draw_tokens``, ``head_epilogue``); ``head_tokens`` is the plain version
of the CUDA kernel in ``csrc/head_tokens.cu``.

``row_uniforms`` reproduces ``jax.random.uniform(fold_in(key(seed), pos))``
bit for bit (threefry2x32, ``jax_threefry_partitionable=True``) with int64
tensor arithmetic masked to 32 bits, on the tensors' own device, so a
sampled decode step needs no host transfer for its randomness.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...models.layers import unembed
from ..fused_sampling import ref as sref

RED_TILE = sref.RED_TILE
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on uint32 values held in int64 tensors:
    key (k0, k1), counter (x0, x1) -> two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def row_uniforms(seeds: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Per-row draw uniforms [S] float32 in [0, 1): for a uint32 seed s and
    position p, key(s) = (0, s), fold_in(key, p) = threefry(key, (0, p)),
    and the uniform takes the xor of threefry(folded, (0, 0)) as 32 random
    bits, keeps the top 23 as the mantissa of a float in [1, 2), minus 1."""
    s = seeds.long() & _MASK
    p = positions.to(s.device).long() & _MASK
    zero = torch.zeros_like(s)
    k0, k1 = threefry2x32(zero, s, zero, p)
    b0, b1 = threefry2x32(k0, k1, zero, zero)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f, 0.0)


def pad_tiles(u: torch.Tensor) -> torch.Tensor:
    """``u`` [S, V] -> [S, n, RED_TILE], zero-padded on the right."""
    s, v = u.shape
    pad = (-v) % RED_TILE
    if pad:
        u = torch.cat([u, u.new_zeros((s, pad))], dim=-1)
    return u.reshape(s, -1, RED_TILE)


def draw_tokens(lg_f: torch.Tensor, rs: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw: filtered scaled logits [S, V] and uniforms [S] ->
    int32 tokens [S]. The token is the first index whose prefix mass
    exceeds ``rs * Z``; 0 when none does. A lane's prefix mass is the
    canonical fold of the preceding tiles plus its in-tile prefix sum,
    summed strictly in lane order (the order the CUDA draw kernel in
    ``fused_sampling/csrc/sampling.cu`` follows)."""
    s, _ = lg_f.shape
    lg_f = lg_f.float()
    m = lg_f.max(dim=-1).values
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    u = pad_tiles(torch.exp(lg_f - safe_m[:, None]))           # [S, n, T]
    prefix = sref.fold_prefix(sref.tile_partial_sums(u.reshape(s, -1)))
    target = rs.float().to(lg_f.device) * prefix[:, -1]
    acc = torch.cat([prefix.new_zeros((s, 1)), prefix[:, :-1]], dim=1)
    cs = torch.empty_like(u)
    c = torch.zeros_like(acc)
    for j in range(RED_TILE):
        c = c + u[:, :, j]
        cs[:, :, j] = acc + c
    hit = (cs > target[:, None, None]).reshape(s, -1)
    idx = hit.to(torch.uint8).argmax(dim=-1)
    return torch.where(hit.any(dim=-1), idx, torch.zeros_like(idx)).int()


def head_epilogue(logits: torch.Tensor, rs: torch.Tensor,
                  temps: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor, *, sampled: bool,
                  filtered: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused head's epilogue on materialized logits [S, V] ->
    ``(tokens int32 [S], ok bool [S])``: the greedy argmax and the
    all-finite probe of the raw logits, then for sampled rows temperature
    scaling, the top-k / top-p bisection filter and the inverse-CDF draw.
    The same ops in the same order as ``serving.sampling.sample_tokens``,
    so the tokens are bitwise those of the unfused sampler."""
    ok = torch.isfinite(logits).all(dim=-1)
    greedy = torch.argmax(logits, dim=-1).int()
    if not sampled:
        return greedy, ok
    temps = temps.float()
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    lg = logits.float() / safe_t[:, None]
    if filtered:
        lg = sref.filter_logits_bisect(lg, top_k.int(), top_p.float())
    drawn = draw_tokens(lg, rs)
    return torch.where(temps > 0, drawn, greedy), ok


def head_tokens(x: torch.Tensor, w: torch.Tensor, rs: torch.Tensor,
                temps: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor,
                *, sampled: bool, filtered: bool, untied: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain fused head: final hidden ``x`` [S, D] and the tied embedding
    ``w`` [V, D], or with ``untied`` the head ``w`` [D, V] -> ``head_epilogue``
    of the logits exactly as ``models.layers.unembed`` computes them (its
    ``p["head"]`` branch for an untied head)."""
    logits = unembed({"head": w}, x, None) if untied \
        else unembed({}, x, w)
    return head_epilogue(logits, rs, temps, top_k, top_p, sampled=sampled,
                         filtered=filtered)
