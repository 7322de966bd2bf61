"""Wrappers for the paged attention kernels (``csrc/paged_attention.cu``).

Dispatch is on the tensors' device: CPU tensors take the plain PyTorch
version in ``ref.py``; CUDA tensors launch the hand-written sm_90a kernel or
raise. There is no fallback from one to the other. ``LAUNCHES`` counts the
kernel launches of each wrapper (plain calls do not count).

Layouts are the JAX package's: q ``[B, Hq, D]`` (decode) or ``[C, Hq, D]``
(one prefill chunk), pools ``[P, page, Hkv, D]``, ``page_table [B,
max_pages]`` / ``page_row [max_pages]`` int32, ``seq_lens [B]`` int32.
"""
from __future__ import annotations

import torch

from .. import _build
from . import ref

LAUNCHES = {"paged_decode_attention": 0, "paged_prefill_attention": 0}

_LIB = "paged_attention"


def _check_common(q, k_pages, v_pages):
    if q.dtype != torch.bfloat16:
        raise TypeError(f"paged attention kernel takes bfloat16 q, got "
                        f"{q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q and the K/V pools must share a dtype")
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4:
        raise ValueError(f"pools must both be [P, page, Hkv, D]: "
                         f"{tuple(k_pages.shape)} {tuple(v_pages.shape)}")
    _, _, hkv, d = k_pages.shape
    hq = q.shape[1]
    if q.dim() != 3 or q.shape[2] != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pages.shape)} (Hq must be a multiple of "
                         "Hkv, head dims equal)")
    g = hq // hkv
    if d != 128 or g > 4:
        raise ValueError(f"the kernel is built for head dim 128 with up to 4 "
                         f"query heads per KV head (llama3.2-3b), got d={d}, "
                         f"G={g}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "reads rows with vector loads)")


def _check_index(name, t, shape, device):
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be a contiguous int32 {shape} tensor "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def paged_decode_attention(q, k_pages, v_pages, page_table, seq_lens):
    """Single-query GQA attention over paged K/V -> [B, Hq, D]. Rows with
    seq_len 0 come back as zeros from the kernel."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention(q, k_pages, v_pages, page_table,
                                          seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_common(q, k_pages, v_pages)
    b, hq, d = q.shape
    _, page_size, hkv, _ = k_pages.shape
    _check_index("page_table", page_table, (b, page_table.shape[1]), q.device)
    _check_index("seq_lens", seq_lens, (b,), q.device)
    out = torch.empty_like(q)
    fn = _build.bind(_LIB, "paged_decode_attention", 6, 6)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
             b, hq, hkv, d, page_size, page_table.shape[1], _stream(q))
    _build.check(err, "paged_decode_attention")
    LAUNCHES["paged_decode_attention"] += 1
    return out


def paged_prefill_attention(q, k_pages, v_pages, page_row, start: int,
                            total_len: int):
    """One prefill chunk of one sequence against its paged cache ->
    [C, Hq, D]. ``start``/``total_len`` are host integers."""
    if q.device.type == "cpu":
        return ref.paged_prefill_attention(q, k_pages, v_pages, page_row,
                                           start, total_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_common(q, k_pages, v_pages)
    c, hq, d = q.shape
    _, page_size, hkv, _ = k_pages.shape
    _check_index("page_row", page_row, (page_row.shape[0],), q.device)
    start, total_len = int(start), int(total_len)
    if not 0 <= start <= total_len <= page_row.shape[0] * page_size:
        raise ValueError(f"need 0 <= start ({start}) <= total_len "
                         f"({total_len}) <= page capacity")
    out = torch.empty_like(q)
    fn = _build.bind(_LIB, "paged_prefill_attention", 5, 8)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_row.data_ptr(), out.data_ptr(), c, hq, hkv, d, page_size,
             page_row.shape[0], start, total_len, _stream(q))
    _build.check(err, "paged_prefill_attention")
    LAUNCHES["paged_prefill_attention"] += 1
    return out
