"""Wrappers for the paged attention kernels (``csrc/paged_attention.cu``).

Dispatch is on the tensors' device: CPU tensors take the plain PyTorch
version in ``ref.py``; CUDA tensors launch the hand-written sm_90a kernel or
raise. There is no fallback from one to the other. ``LAUNCHES`` counts the
kernel launches of each wrapper (plain calls do not count).

Layouts are the JAX package's: q ``[B, Hq, D]`` (decode) or ``[C, Hq, D]``
(one prefill chunk), pools ``[P, page, Hkv, D]``, ``page_table [B,
max_pages]`` / ``page_row [max_pages]`` int32, ``seq_lens [B]`` int32.

The kernel cuts keys into tiles of ``KEY_TILE`` and deals tile t to rank t
mod ``split`` of a thread block cluster. ``decode_plan``
and ``prefill_plan`` choose ``split`` on the host from shapes and host
integers alone: the decode wrapper never reads ``seq_lens`` back.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from ...core import optrace
from .. import _build
from .._grad import refuse_grad
from . import ref

LAUNCHES = {"paged_decode_attention": 0, "paged_prefill_attention": 0}

_LIB = "paged_attention"

HEAD_DIM = 128      # the one head dim the kernel is built for
MAX_G = 16          # query heads a KV head, at most (one m16 tile)
PAGE_ROWS = 8       # a page size must be a multiple of this (a TMA box)
KEY_TILE = 16       # keys a tile
ROW_TILE = 64       # flattened (token, query head) rows a prefill CTA
MAX_SPLIT = 8       # CTAs a cluster, the portable most
SMS = 132           # an H100 SXM's SMs: the CTAs a split aims to fill


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def decode_plan(b: int, hkv: int, max_pages: int, page_size: int) -> int:
    """CTAs of one (slot, KV head) cluster: the least split that puts
    ``SMS`` CTAs or more on the card (decode waits on memory, so a second
    CTA on an SM hides latency), at most ``MAX_SPLIT`` and no more than the
    key tiles a row can hold."""
    return max(1, min(MAX_SPLIT, _cdiv(SMS, b * hkv),
                      _cdiv(max_pages * page_size, KEY_TILE)))


def prefill_keys(c: int, g: int, start: int, total: int, cap: int,
                 row_tile: int) -> int:
    """Keys that the last row of prefill row tile ``row_tile`` sees (rows
    are the chunk's (token, query head) pairs, ``ROW_TILE`` a tile): causal
    from its position, clipped at ``total`` and at the page capacity."""
    last = (min((row_tile + 1) * ROW_TILE, c * g) - 1) // g
    return min(start + last + 1, total, cap)


def prefill_plan(c: int, hq: int, hkv: int, start: int, total: int,
                 page_size: int, max_pages: int) -> Tuple[int, int]:
    """(split, row tiles) of one prefill chunk: a cluster of ``split`` CTAs
    per (KV head, row tile), the least power of two that puts ``SMS`` CTAs
    or more on the card (clusters of 5 or 6 pack an H100's GPCs unevenly),
    at most ``MAX_SPLIT`` and at most half the key tiles of the last row
    tile, so that a rank has two."""
    g = hq // hkv
    row_tiles = _cdiv(c * g, ROW_TILE)
    keys = prefill_keys(c, g, start, total, max_pages * page_size,
                        row_tiles - 1)
    split = 1
    while split < MAX_SPLIT and hkv * row_tiles * split < SMS:
        split *= 2
    return max(1, min(split, _cdiv(_cdiv(keys, KEY_TILE), 2))), row_tiles


def check_kernel_args(q, k_pages, v_pages):
    """Raise on what the kernel does not take (no launch; the wrappers call
    it on CUDA tensors)."""
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
    if d != HEAD_DIM or g > MAX_G:
        raise ValueError(f"the kernel is built for head dim {HEAD_DIM} with 1 "
                         f"to {MAX_G} query heads per KV head, got d={d}, "
                         f"G={g}")
    if k_pages.shape[1] % PAGE_ROWS:
        raise ValueError(f"the kernel reads pages in boxes of {PAGE_ROWS} "
                         f"rows: page size {k_pages.shape[1]} is not a "
                         "multiple")
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


def _launch_decode(q, k_pages, v_pages, page_table, seq_lens, out,
                   split: int, lib: str = _LIB) -> None:
    """One launch of library ``lib``'s decode kernel on checked inputs
    (``paged_ablations.py`` passes other splits and libraries)."""
    b, hq, d = q.shape
    num_pages, page_size, hkv, _ = k_pages.shape
    fn = _build.bind(lib, "paged_decode_attention", 6, 8)
    _build.check(fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    page_table.data_ptr(), seq_lens.data_ptr(),
                    out.data_ptr(), b, hq, hkv, d, page_size,
                    page_table.shape[1], num_pages, split, _stream(q)),
                 "paged_decode_attention")


def _launch_prefill(q, k_pages, v_pages, page_row, start: int, total: int,
                    out, split: int, lib: str = _LIB) -> None:
    """One launch of library ``lib``'s prefill kernel on checked inputs."""
    c, hq, d = q.shape
    num_pages, page_size, hkv, _ = k_pages.shape
    fn = _build.bind(lib, "paged_prefill_attention", 5, 10)
    _build.check(fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    page_row.data_ptr(), out.data_ptr(), c, hq, hkv, d,
                    page_size, page_row.shape[0], num_pages, start, total,
                    split, _stream(q)),
                 "paged_prefill_attention")


def _naive_flops(b: int, hq: int, sq: int, sk: int, d: int, causal: bool
                 ) -> float:
    """FLOPs of ``models.attention.naive_attention`` over K/V gathered to
    ``sk`` keys, with a ``kv_len`` mask, as ``core/characterize.py`` counts
    them: the scale, the two products, the masks and the softmax."""
    n = b * hq * sq * sk
    flops = 1.0 + 4.0 * n * d + sq + 7.0 * n + b * sk
    if causal:
        flops += n + sq * sk
    return flops


def paged_decode_attention_flops(q, k_pages, v_pages, page_table,
                                 seq_lens) -> float:
    """The plain version's FLOPs: every key of the table's pages."""
    b, hq, d = q.shape
    return _naive_flops(b, hq, 1, page_table.shape[1] * k_pages.shape[1], d,
                        causal=False)


def paged_prefill_attention_flops(q, k_pages, v_pages, page_row, start,
                                  total_len) -> float:
    c, hq, d = q.shape
    return _naive_flops(1, hq, c, page_row.shape[0] * k_pages.shape[1], d,
                        causal=True)


@optrace.kernel_op("paged_decode_attention", paged_decode_attention_flops)
def paged_decode_attention(q, k_pages, v_pages, page_table, seq_lens):
    """Single-query GQA attention over paged K/V -> [B, Hq, D]. Rows with
    seq_len 0 come back as zeros from the kernel."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention(q, k_pages, v_pages, page_table,
                                          seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    refuse_grad("paged_decode_attention", q, k_pages, v_pages)
    check_kernel_args(q, k_pages, v_pages)
    b = q.shape[0]
    _, page_size, hkv, _ = k_pages.shape
    _check_index("page_table", page_table, (b, page_table.shape[1]), q.device)
    _check_index("seq_lens", seq_lens, (b,), q.device)
    out = torch.empty_like(q)
    _launch_decode(q, k_pages, v_pages, page_table, seq_lens, out,
                   decode_plan(b, hkv, page_table.shape[1], page_size))
    LAUNCHES["paged_decode_attention"] += 1
    return out


@optrace.kernel_op("paged_prefill_attention", paged_prefill_attention_flops)
def paged_prefill_attention(q, k_pages, v_pages, page_row, start: int,
                            total_len: int):
    """One prefill chunk of one sequence against its paged cache ->
    [C, Hq, D]. ``start``/``total_len`` are host integers."""
    if q.device.type == "cpu":
        return ref.paged_prefill_attention(q, k_pages, v_pages, page_row,
                                           start, total_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    refuse_grad("paged_prefill_attention", q, k_pages, v_pages)
    check_kernel_args(q, k_pages, v_pages)
    c, hq, _ = q.shape
    _, page_size, hkv, _ = k_pages.shape
    _check_index("page_row", page_row, (page_row.shape[0],), q.device)
    start, total_len = int(start), int(total_len)
    if not 0 <= start <= total_len <= page_row.shape[0] * page_size:
        raise ValueError(f"need 0 <= start ({start}) <= total_len "
                         f"({total_len}) <= page capacity")
    out = torch.empty_like(q)
    split, _ = prefill_plan(c, hq, hkv, start, total_len, page_size,
                            page_row.shape[0])
    _launch_prefill(q, k_pages, v_pages, page_row, start, total_len, out,
                    split)
    LAUNCHES["paged_prefill_attention"] += 1
    return out
