"""Wrapper of the fused LM head kernel (``csrc/head_tokens.cu``): final
hidden [S, D] and the tied embedding [V, D], or an untied head [D, V]
(``untied=True``), read in place -> sampled tokens, with no fp32 [S, V]
logits tensor.

CPU tensors take the plain version (``ref.head_tokens``); CUDA tensors
launch the hand-written sm_90a kernel (two launches: the GEMV into a bf16
workspace, in groups of 8 hidden rows, through the tensor cores for a tied
embedding and the CUDA cores for an untied head, then the per-row epilogue, a thread
block cluster a row of ``fused_sampling.ops.cluster_plan`` CTAs, which
draws with each row's uniform computed from its request seed and stream
position on the card) or raise. Any number of rows S is served, so an
engine of any slot count can run fused decode. ``LAUNCHES`` counts calls
that launch the kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from ..fused_sampling.ops import check_draw_keys, cluster_plan
from . import ref

LAUNCHES = {"head_tokens": 0}

_LIB = "head_tokens"
ROWS_PER_CTA = 128               # vocab rows per GEMV CTA
MAX_VOCAB = 65535 * ROWS_PER_CTA  # the GEMV grid's y extent


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
    engine's step flags."""
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
            lib: str = _LIB, untied: bool = False) -> None:
    """One call of library ``lib``'s two kernels on checked tensors (the
    untied head's GEMV with ``untied``), the epilogue ``size`` CTAs a row
    (``lib`` other than the package's own only for
    ``sampler_ablations.py``)."""
    s, d = x.shape
    v = embedding.shape[int(untied)]
    n_blk = -(-v // ROWS_PER_CTA)
    ws = torch.empty((s, v), dtype=torch.bfloat16, device=x.device)
    scratch = torch.empty((3, s, n_blk), dtype=torch.int32, device=x.device)
    fn = _build.bind(lib, "head_tokens_untied" if untied else "head_tokens",
                     11, 7)
    err = fn(x.data_ptr(), embedding.data_ptr(), seeds.data_ptr(),
             positions.data_ptr(), temps.data_ptr(), top_k.data_ptr(),
             top_p.data_ptr(), ws.data_ptr(), scratch.data_ptr(),
             tokens.data_ptr(), ok.data_ptr(), s, d, v, pos64,
             int(bool(sampled)), int(bool(filtered)), size,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "head_tokens")
