"""Wrappers for the sampler's kernels (``csrc/sampling.cu``): the top-k /
top-p filter and the inverse-CDF token draw.

CPU tensors take the plain versions (``ref.filter_logits_bisect``,
``fused_lm_head.ref.draw_tokens``); CUDA tensors launch the hand-written
sm_90a kernels or raise. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import _build
from ..fused_lm_head import ref as head_ref
from . import ref

LAUNCHES = {"filter_logits": 0, "draw_tokens": 0}

_LIB = "sampling"


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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def filter_logits(lg: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """Mask ``lg`` [S, V] float32 to its top-k / nucleus top-p support
    (dropped entries at -inf); ``top_k`` int32 [S] (<= 0 disables),
    ``top_p`` float32 [S] (>= 1 disables)."""
    if lg.device.type == "cpu":
        return ref.filter_logits_bisect(lg, top_k, top_p)
    _check_logits(lg)
    _check_row("top_k", top_k, torch.int32, lg)
    _check_row("top_p", top_p, torch.float32, lg)
    s, v = lg.shape
    if s == 0:
        return lg.clone()
    out = torch.empty_like(lg)
    fn = _build.bind(_LIB, "filter_logits", 4, 2)
    err = fn(lg.data_ptr(), top_k.data_ptr(), top_p.data_ptr(),
             out.data_ptr(), s, v, _stream(lg))
    _build.check(err, "filter_logits")
    LAUNCHES["filter_logits"] += 1
    return out


def draw_tokens(lg_f: torch.Tensor, rs: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw: filtered scaled logits ``lg_f`` [S, V] float32 and
    uniforms ``rs`` float32 [S] -> int32 tokens [S]."""
    if lg_f.device.type == "cpu":
        return head_ref.draw_tokens(lg_f, rs)
    _check_logits(lg_f)
    _check_row("rs", rs, torch.float32, lg_f)
    s, v = lg_f.shape
    out = torch.empty((s,), dtype=torch.int32, device=lg_f.device)
    if s == 0:
        return out
    fn = _build.bind(_LIB, "draw_tokens", 3, 2)
    err = fn(lg_f.data_ptr(), rs.data_ptr(), out.data_ptr(), s, v,
             _stream(lg_f))
    _build.check(err, "draw_tokens")
    LAUNCHES["draw_tokens"] += 1
    return out
