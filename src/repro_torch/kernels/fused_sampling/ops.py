"""Wrappers for the sampler's kernels (``csrc/sampling.cu``): the top-k /
top-p filter and the inverse-CDF token draw, which computes each row's
uniform from its request seed and stream position on the card.

CPU tensors take the plain versions (``ref.filter_logits_bisect``,
``fused_lm_head.ref.draw_tokens`` of ``fused_lm_head.ref.row_uniforms``);
CUDA tensors launch the hand-written sm_90a kernels or raise. ``LAUNCHES``
counts kernel launches; under an ``optrace`` recorder the filter and the
draw are one op each, of the FLOPs ``filter_logits_flops`` and
``draw_tokens_flops`` state.

The filter, the draw and the fused LM head's epilogue spread a row over a
thread block cluster whose CTAs keep the row in shared memory;
``cluster_plan`` chooses its size from the shapes alone.
"""
from __future__ import annotations

import functools

import torch

from ...core import optrace
from .. import _build
from .._grad import refuse_grad
from ..fused_lm_head import ref as head_ref
from . import ref

LAUNCHES = {"filter_logits": 0, "draw_tokens": 0, "row_uniforms": 0}

_LIB = "sampling"

TILE = ref.RED_TILE          # lanes of a mass tile
STRIDE = TILE + 4            # words a tile takes in a CTA's shared copy
MAX_CLUSTER = 16             # CTAs a cluster (16 is past the portable 8)
SMEM_BYTES = 232448 - 10240  # dynamic shared memory a CTA may take (its
                             # static scratch, under 10 KB, aside)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _recv_ranks(v: int, size: int) -> int:
    """The other ranks whose sweep partials rank 0 receives at once
    (``sampling_device.cuh`` ``cluster_recv_segments``): as many as its
    shared memory holds beside the rest, at least one, at most size - 1."""
    if size <= 1:
        return 0
    per = _cdiv(_cdiv(v, TILE), size)
    fit = (SMEM_BYTES // 4 - per * (2 * STRIDE + ref.CANDIDATES)) // (
        per * ref.CANDIDATES)
    return max(1, min(size - 1, fit))


def cluster_smem_bytes(v: int, size: int) -> int:
    """Dynamic shared memory of one CTA of a ``size``-CTA row of ``v``
    entries (``sampling_device.cuh`` ``cluster_smem_words``): keys and
    masses of its tiles and ``ref.CANDIDATES`` sweep partials for each of
    them (rank 0's also hold one mass a tile of the row), then rank 0's
    receive buffer for the partials of the other ranks' tiles, as many
    ranks as the shared memory holds beside the rest (at every served width
    all of them; a wider row goes in rounds), which is also the draw's
    prefix a tile."""
    n_tiles = _cdiv(v, TILE)
    per = _cdiv(n_tiles, size)
    own = per * ref.CANDIDATES
    sweep = (1 + _recv_ranks(v, size)) * own
    draw = max(own, _cdiv(n_tiles, 4) * 4) + n_tiles
    return 4 * (per * 2 * STRIDE + max(sweep, draw))


def sweep_rounds(v: int, size: int) -> int:
    """Rounds in which rank 0 receives a nucleus sweep's partials."""
    k = _recv_ranks(v, size)
    return _cdiv(size - 1, k) if k else 1


def _max_row() -> int:
    """The widest row the shared memory of ``MAX_CLUSTER`` CTAs holds, in
    whole 128-entry tiles."""
    n = 1
    while cluster_smem_bytes((n + 1) * TILE, MAX_CLUSTER) <= SMEM_BYTES:
        n += 1
    return n * TILE


MAX_ROW = _max_row()         # 382,976 entries


# Clusters of a size an H100 SXM runs at once at one CTA an SM (its GPCs
# hold 7 clusters of 10-16 CTAs, 9 of 9, 15 of 7 or 8;
# cudaOccupancyMaxActiveClusters, printed by sampler_ablations.py, the same
# at 50,304, 128,256 and 256,000 entries wherever the row fits).
ACTIVE_CLUSTERS = {16: 7, 15: 7, 14: 7, 13: 7, 12: 7, 11: 7, 10: 7, 9: 9,
                   8: 15}


@functools.lru_cache(maxsize=None)
def cluster_plan(s: int, v: int) -> int:
    """CTAs a row for ``s`` rows of ``v`` entries: the largest size of
    ``ACTIVE_CLUSTERS`` whose clusters all run at once (a row that waits
    for a free cluster doubles the call), else 8 (several waves; small
    clusters pack best); where 8 CTAs cannot hold the row in shared
    memory, the size that holds it in the fewest waves, the largest of
    those (a wave's fixed cost outweighs its share of the tiles: at [8,
    256000] every size from 11 runs 7 clusters at once, and 16 is the
    quickest); never more than the row's 128-entry tiles. Raises when 16
    CTAs cannot hold the row (past ``MAX_ROW`` entries)."""
    def holds(z):
        return cluster_smem_bytes(v, z) <= SMEM_BYTES
    fits = [z for z in sorted(ACTIVE_CLUSTERS, reverse=True)
            if ACTIVE_CLUSTERS[z] >= s and holds(z)]
    if fits:
        size = fits[0]
    elif holds(8):
        size = 8
    else:
        held = [z for z in ACTIVE_CLUSTERS if holds(z)]
        if not held:
            raise ValueError(f"a row of {v} entries does not fit the shared "
                             f"memory of {MAX_CLUSTER} CTAs (at most "
                             f"{MAX_ROW})")
        size = min(held, key=lambda z: (_cdiv(s, ACTIVE_CLUSTERS[z]), -z))
    return max(1, min(size, _cdiv(v, TILE)))


def _check_logits(lg: torch.Tensor) -> None:
    if lg.device.type != "cuda":
        raise ValueError(f"unsupported device {lg.device}")
    if lg.dtype != torch.float32 or lg.dim() != 2 or not lg.is_contiguous():
        raise ValueError(f"logits must be a contiguous float32 [S, V] tensor,"
                         f" got {lg.dtype} {tuple(lg.shape)}")


def _check_row(name: str, t: torch.Tensor, dtype, lg: torch.Tensor) -> None:
    s = lg.shape[0]
    if t.dtype != dtype or tuple(t.shape) != (s,) or t.device != lg.device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} [{s}] tensor "
                         f"on {lg.device}")


def check_draw_keys(seeds: torch.Tensor, positions: torch.Tensor, s: int,
                    device: torch.device) -> int:
    """Raise unless ``seeds`` is a contiguous int64 [s] tensor (uint32
    values) and ``positions`` a contiguous int32 or int64 [s] tensor, both
    on ``device``; returns 1 for int64 positions, else 0 (the kernels'
    ``pos64``)."""
    if seeds.dtype != torch.int64 or tuple(seeds.shape) != (s,) \
            or seeds.device != device or not seeds.is_contiguous():
        raise ValueError(f"seeds must be a contiguous int64 [{s}] tensor on "
                         f"{device}, got {seeds.dtype} {tuple(seeds.shape)} "
                         f"on {seeds.device}")
    if positions.dtype not in (torch.int32, torch.int64) \
            or tuple(positions.shape) != (s,) \
            or positions.device != device or not positions.is_contiguous():
        raise ValueError(f"positions must be a contiguous int32 or int64 "
                         f"[{s}] tensor on {device}, got {positions.dtype} "
                         f"{tuple(positions.shape)} on {positions.device}")
    return int(positions.dtype == torch.int64)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# FLOPs of the plain versions, as ``core/characterize.py`` counts their ops
# (elementwise ops an element of their result, reductions an element of
# their input); a row of V logits spans T = ceil(V / 128) mass tiles.
UNIFORM_FLOPS = 349          # a row's threefry2x32 pair and float assembly


def filter_flops(s: int, v: int) -> float:
    """The bisection filter: 149 ops an element over its two 32-step
    bisections, 510 a row, and 33 canonical tile sums (127 adds a tile)."""
    return 149.0 * s * v + 510.0 * s + 33.0 * 127.0 * s * _cdiv(v, TILE)


def draw_flops(s: int, v: int) -> float:
    """The draw on given uniforms: max, shift and exp (3 an element), 7 a
    row, and a tile's halving tree, 256 prefix adds and the hit search
    (767 a tile)."""
    return 3.0 * s * v + 7.0 * s + 767.0 * s * _cdiv(v, TILE)


def filter_logits_flops(lg, top_k, top_p) -> float:
    return filter_flops(*lg.shape)


def draw_tokens_flops(lg_f, seeds, positions) -> float:
    """The draw with each row's uniform computed in the call."""
    s, v = lg_f.shape
    return draw_flops(s, v) + UNIFORM_FLOPS * s


@optrace.kernel_op("filter_logits", filter_logits_flops)
def filter_logits(lg: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """Mask ``lg`` [S, V] float32 to its top-k / nucleus top-p support
    (dropped entries at -inf); ``top_k`` int32 [S] (<= 0 disables),
    ``top_p`` float32 [S] (>= 1 disables). On the card V is bounded by
    ``cluster_plan``."""
    if lg.device.type == "cpu":
        return ref.filter_logits_bisect(lg, top_k, top_p)
    refuse_grad("filter_logits", lg)
    _check_logits(lg)
    _check_row("top_k", top_k, torch.int32, lg)
    _check_row("top_p", top_p, torch.float32, lg)
    s, v = lg.shape
    if s == 0:
        return lg.clone()
    out = torch.empty_like(lg)
    _launch_filter(lg, top_k, top_p, out, cluster_plan(s, v))
    LAUNCHES["filter_logits"] += 1
    return out


def _launch_filter(lg, top_k, top_p, out, size: int, lib: str = _LIB) -> None:
    """One launch of library ``lib``'s filter kernel, ``size`` CTAs a row
    (checked tensors; ``lib`` other than the package's own only for
    ``sampler_ablations.py``)."""
    s, v = lg.shape
    fn = _build.bind(lib, "filter_logits", 4, 3)
    err = fn(lg.data_ptr(), top_k.data_ptr(), top_p.data_ptr(),
             out.data_ptr(), s, v, size, _stream(lg))
    _build.check(err, "filter_logits")


@optrace.kernel_op("draw_tokens", draw_tokens_flops)
def draw_tokens(lg_f: torch.Tensor, seeds: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw: filtered scaled logits ``lg_f`` [S, V] float32 ->
    int32 tokens [S], row i drawn with the uniform of request seed
    ``seeds[i]`` (int64 holding a uint32) at stream position
    ``positions[i]`` (int32 or int64), ``fused_lm_head.ref.row_uniforms``
    bit for bit. On the card V is bounded by ``cluster_plan``."""
    if lg_f.dim() != 2:
        raise ValueError(f"logits must be [S, V], got {tuple(lg_f.shape)}")
    pos64 = check_draw_keys(seeds, positions, lg_f.shape[0], lg_f.device)
    if lg_f.device.type == "cpu":
        return head_ref.draw_tokens(lg_f,
                                    head_ref.row_uniforms(seeds, positions))
    _check_logits(lg_f)
    s, v = lg_f.shape
    out = torch.empty((s,), dtype=torch.int32, device=lg_f.device)
    if s == 0:
        return out
    _launch_draw(lg_f, seeds, positions, out, pos64, cluster_plan(s, v))
    LAUNCHES["draw_tokens"] += 1
    return out


def _launch_draw(lg_f, seeds, positions, out, pos64: int, size: int,
                 lib: str = _LIB) -> None:
    """One launch of library ``lib``'s draw kernel, ``size`` CTAs a row
    (checked tensors; ``lib`` other than the package's own only for
    ``sampler_ablations.py``)."""
    s, v = lg_f.shape
    fn = _build.bind(lib, "draw_tokens", 4, 4)
    err = fn(lg_f.data_ptr(), seeds.data_ptr(), positions.data_ptr(),
             out.data_ptr(), s, v, pos64, size, _stream(lg_f))
    _build.check(err, "draw_tokens")


def device_row_uniforms(seeds: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
    """The draw kernels' uniforms alone, from the device function they run
    (CUDA tensors only): float32 [S]. For holding them against
    ``fused_lm_head.ref.row_uniforms`` on the card; no sampling path calls
    it."""
    if seeds.device.type != "cuda":
        raise ValueError(f"unsupported device {seeds.device}: the device "
                         "uniforms run on the card")
    n = seeds.shape[0] if seeds.dim() == 1 else -1
    pos64 = check_draw_keys(seeds, positions, n, seeds.device)
    out = torch.empty((n,), dtype=torch.float32, device=seeds.device)
    if n == 0:
        return out
    fn = _build.bind(_LIB, "row_uniforms", 3, 2)
    err = fn(seeds.data_ptr(), positions.data_ptr(), out.data_ptr(), n, pos64,
             _stream(seeds))
    _build.check(err, "row_uniforms")
    LAUNCHES["row_uniforms"] += 1
    return out
