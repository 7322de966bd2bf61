"""Wrapper of the fused LM head kernel (``csrc/head_tokens.cu``): final
hidden [S, D] and the tied embedding [V, D], or an untied head [D, V]
(``untied=True``), read in place -> sampled tokens, with no fp32 [S, V]
logits tensor.

CPU tensors take the plain version (``ref.head_tokens``); CUDA tensors
launch the hand-written sm_90a kernel (two launches: the GEMV into a bf16
workspace, then the per-row epilogue, a thread block cluster a row of
``fused_sampling.ops.cluster_plan`` CTAs, which draws with each row's
uniform computed from its request seed and stream position on the card) or
raise. The GEMV is bound by the bytes of W (0.42 GB at deepseek-moe-16b's
untied [2048, 102400]). A tied embedding [V, D] goes through ``mma.sync``
in groups of 8 hidden rows. An untied head [D, V] goes through
``head_gemv_wgmma_kernel`` on the plan ``untied_plan`` makes from (S, D, V,
SMs): a TMA ring of W tiles into ``wgmma`` (bytes in flight set by the
ring, not by registers), on a persistent grid of balanced ranges of
64-column tiles (no wave tail), reading W once for any S <= 16. Any number
of rows S is served, so an engine of any slot count can run fused decode.
``LAUNCHES`` counts calls that launch the kernel.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from .. import _build
from ..fused_sampling.ops import check_draw_keys, cluster_plan
from . import ref

LAUNCHES = {"head_tokens": 0}

_LIB = "head_tokens"
ROWS_PER_CTA = 128               # vocab rows per tied GEMV CTA
MAX_VOCAB = 65535 * ROWS_PER_CTA  # the tied GEMV grid's y extent

UNTIED_TILE = 64                 # vocab columns a tile: the wgmma's M
UNTIED_BK = 16                   # K rows of a tile a ring stage: its K
UNTIED_PANELS = (4, 8, 16)       # tiles a ring stage holds side by side
UNTIED_RING_BYTES = 196608       # ring bytes a CTA at most (in flight)
UNTIED_MIN_STAGES = 4
SMEM_BYTES = 232448              # dynamic shared memory a block (H100)


class UntiedPlan(NamedTuple):
    """The untied GEMV's schedule (``untied_plan``)."""
    tile: int                    # vocab columns a tile (and a partial block)
    panel: int                   # tiles a stage holds side by side
    rows: int                    # hidden rows a group: the wgmma's N
    groups: Tuple[Tuple[int, int], ...]  # (first row, rows) a group, in order
    ctas: int                    # the persistent grid: at most one an SM
    ranges: Tuple[Tuple[int, int], ...]  # [first, end) tiles of each CTA
    stages: int                  # ring depth
    smem_bytes: int              # dynamic shared memory of a CTA


def stage_bytes(panel: int) -> int:
    """Bytes of a ring stage: ``UNTIED_BK`` K rows of ``panel`` tiles."""
    return panel * UNTIED_BK * UNTIED_TILE * 2


def untied_smem(d: int, rows: int, panel: int, stages: int) -> int:
    """The untied GEMV's dynamic shared memory (``head_tokens.cu``
    ``untied_smem``): alignment slack, x's group whole, the ring, the
    barriers and the warps' partial keys and finite flags."""
    return (1024 + d * rows * 2 + stages * stage_bytes(panel)
            + 8 * (2 * stages + 2) + panel * rows * 4 * 5)


@functools.lru_cache(maxsize=None)
def untied_plan(s: int, d: int, v: int, n_sm: int) -> UntiedPlan:
    """The schedule of the untied head's GEMV for x [s, d] by W [d, v] on a
    card of ``n_sm`` SMs, a pure function of its arguments (it reads no
    tensor and nothing back from the card):

    - tiles of 64 vocab columns (the last one ragged where 64 does not
      divide v), G = ``min(n_sm, tiles)`` CTAs, CTA c taking the
      contiguous tiles ``[c T // G, (c + 1) T // G)`` (the kernel computes
      the same range from its block index): balanced to one tile, each
      column's sum one CTA's;
    - a ring stage holds the same 16 K rows of a panel of tiles side by
      side: the whole range where it has at most 16 tiles (the least of 4,
      8 and 16 that holds it), so the G CTAs read whole K rows of W at a
      time;
    - hidden rows in groups of 8 (s <= 8) or 16, so W is read once for any
      s <= 16;
    - as many ring stages as shared memory holds beside x's group, up to
      ``UNTIED_RING_BYTES``, at least ``UNTIED_MIN_STAGES``: where they do
      not fit, the panel halves down to 4, then the groups drop to 8 rows.

    Raises ``ValueError`` where even that does not fit (d above 12352)."""
    if s < 1 or d < 64 or d % 64 or v < 16 or v % 16 or n_sm < 1:
        raise ValueError(f"the untied GEMV needs S >= 1, D % 64 == 0, "
                         f"V % 16 == 0 and an SM, got S={s} D={d} V={v} "
                         f"SMs={n_sm}")
    tiles = -(-v // UNTIED_TILE)
    ctas = min(n_sm, tiles)
    most = -(-tiles // ctas)
    widest = next(p for p in UNTIED_PANELS
                  if p >= min(most, UNTIED_PANELS[-1]))
    panel, rows = widest, 8 if s <= 8 else 16
    while untied_smem(d, rows, panel, UNTIED_MIN_STAGES) > SMEM_BYTES:
        if panel > UNTIED_PANELS[0]:
            panel //= 2
        elif rows == 16:
            rows, panel = 8, widest
        else:
            raise ValueError(f"the untied GEMV holds x [8, {d}] in shared "
                             f"memory beside {UNTIED_MIN_STAGES} ring "
                             f"stages: D={d} is too wide (at most 12352)")
    stages = UNTIED_MIN_STAGES
    while (stages + 1) * stage_bytes(panel) <= UNTIED_RING_BYTES and \
            untied_smem(d, rows, panel, stages + 1) <= SMEM_BYTES:
        stages += 1
    ranges = tuple((c * tiles // ctas, (c + 1) * tiles // ctas)
                   for c in range(ctas))
    groups = tuple((r, min(rows, s - r)) for r in range(0, s, rows))
    return UntiedPlan(UNTIED_TILE, panel, rows, groups, ctas, ranges, stages,
                      untied_smem(d, rows, panel, stages))


def partial_blocks(v: int, untied: bool) -> int:
    """Pass 1's partial blocks a row: one a 128-row CTA (tied), one a
    64-column tile (untied)."""
    return -(-v // (UNTIED_TILE if untied else ROWS_PER_CTA))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def head_tokens(x: torch.Tensor, embedding: torch.Tensor,
                seeds: torch.Tensor, positions: torch.Tensor,
                temps: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor,
                *, sampled: bool, filtered: bool, untied: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` [S, D] (model dtype), ``embedding`` the tied weight [V, D] or,
    with ``untied``, the head [D, V], read in place -> ``(tokens int32 [S],
    ok bool [S])``. Row i draws with the
    uniform of request seed ``seeds[i]`` (int64 holding a uint32) at stream
    position ``positions[i]`` (int32 or int64), ``ref.row_uniforms`` bit
    for bit; ``temps`` / ``top_p`` float32, ``top_k`` int32; rows with
    temperature 0 take the raw argmax. ``sampled`` / ``filtered`` are the
    engine's step flags. On the card the kernel takes S >= 1, D % 64 == 0,
    V % 16 == 0 and V <= ``MAX_VOCAB``; an untied head also D <= 12352
    (``untied_plan`` holds x's row group in shared memory)."""
    if x.dim() != 2:
        raise ValueError(f"x must be [S, D], got {tuple(x.shape)}")
    pos64 = check_draw_keys(seeds, positions, x.shape[0], x.device)
    if x.device.type == "cpu":
        rs = ref.row_uniforms(seeds, positions)
        return ref.head_tokens(x, embedding, rs, temps, top_k, top_p,
                               sampled=sampled, filtered=filtered,
                               untied=untied)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    s, d = x.shape
    if x.dtype != torch.bfloat16 or embedding.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16 x and weight, got "
                        f"{x.dtype} and {embedding.dtype}")
    d_axis, v_axis = (0, 1) if untied else (1, 0)
    if embedding.dim() != 2 or embedding.shape[d_axis] != d:
        raise ValueError(f"weight {tuple(embedding.shape)} is not " + (
            f"[{d}, V] (an untied head)" if untied else
            f"[V, {d}] (a tied embedding)"))
    v = embedding.shape[v_axis]
    if s < 1 or d % 64 or v % 16 or v > MAX_VOCAB:
        raise ValueError(f"the kernel needs S >= 1, D % 64 == 0, V % 16 == 0"
                         f" and V <= {MAX_VOCAB}, got S={s} D={d} V={v}")
    for name, t in (("x", x), ("embedding", embedding)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and "
                             f"on {x.device}")
    rows = {"temps": (temps, torch.float32),
            "top_k": (top_k, torch.int32), "top_p": (top_p, torch.float32)}
    for name, (t, dtype) in rows.items():
        if t.dtype != dtype or tuple(t.shape) != (s,) or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} [{s}] "
                             f"tensor on {x.device}")
    tokens = torch.empty((s,), dtype=torch.int32, device=x.device)
    ok = torch.empty((s,), dtype=torch.bool, device=x.device)
    _launch(x, embedding, seeds, positions, pos64, temps, top_k, top_p,
            tokens, ok, sampled, filtered,
            cluster_plan(s, v) if sampled else 1, untied=untied)
    LAUNCHES["head_tokens"] += 1
    return tokens, ok


def _launch(x, embedding, seeds, positions, pos64, temps, top_k, top_p,
            tokens, ok, sampled, filtered, size: int,
            lib: str = _LIB, untied: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of library ``lib``'s two kernels on checked tensors (with
    ``untied``, the untied head's GEMV on ``untied_plan``), the epilogue
    ``size`` CTAs a row (``lib`` other than the package's own only for
    ``sampler_ablations.py``). Returns pass 1's bf16 workspace [S, V] and
    partials [3, S, blocks] (for checks)."""
    s, d = x.shape
    v = embedding.shape[int(untied)]
    plan = untied_plan(s, d, v, sm_count(x.device.index)) if untied \
        else None
    n_blk = partial_blocks(v, untied)
    ws = torch.empty((s, v), dtype=torch.bfloat16, device=x.device)
    scratch = torch.empty((3, s, n_blk), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), embedding.data_ptr(), seeds.data_ptr(),
            positions.data_ptr(), temps.data_ptr(), top_k.data_ptr(),
            top_p.data_ptr(), ws.data_ptr(), scratch.data_ptr(),
            tokens.data_ptr(), ok.data_ptr(), s, d, v, pos64,
            int(bool(sampled)), int(bool(filtered)), size)
    if untied:
        err = _build.bind(lib, "head_tokens_untied", 11, 11)(
            *args, plan.rows, plan.panel, plan.ctas, plan.stages, stream)
    else:
        err = _build.bind(lib, "head_tokens", 11, 7)(*args, stream)
    _build.check(err, "head_tokens")
    return ws, scratch
