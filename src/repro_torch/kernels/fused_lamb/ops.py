"""Wrapper of the fused LAMB kernels (``csrc/fused_lamb.cu``): the Fig. 3
update, in place, of one leaf or of leaves that share their trust ratios
(whisper's encoder layers, one leaf in JAX's stacked tree), one ratio a
row (``rows``: a MoE expert leaf's experts; 1, the whole leaf, for every
other leaf) (``lamb_update_``); or of a data-parallel rank's columns of
the ZeRO flat leaves, the partial norms summed across the ranks between
the two stages (``lamb_update_shards_``).

CPU tensors take the plain version (``ref.lamb_stage1``, the squared norms,
the trust ratio and ``ref.lamb_stage2``, with the card's layout of partial
norms at one partial a row) and copy its results into ``w``, ``m`` and
``v``; CUDA tensors launch the two hand-written sm_90a kernels or raise.
``LAUNCHES`` counts kernel launches. ``stage1`` and ``stage2`` are one op
each of an ``optrace`` trace, with the FLOPs ``stage1_flops`` and
``stage2_flops`` state.
Nothing here reads a device value on the host: ``ginv``, ``c1`` and ``c2``
arrive as a 3-float device tensor, and stage 2 reduces stage 1's per-block
partial norms itself, so a step of many leaves never waits on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core import optrace
from .. import _build
from . import ref

LAUNCHES = {"lamb_stage1": 0, "lamb_stage2": 0}

_LIB = "fused_lamb"
_THREADS = 256
_MAX_BLOCKS = 4 * 132        # four CTAs on each of the H100's 132 SMs


def grid_blocks(n: int, rows: int = 1) -> int:
    """CTAs a row of both stages for ``rows`` rows of ``n`` elements (each
    thread takes four elements a sweep; grid-stride beyond): at most
    ``_MAX_BLOCKS`` CTAs in all, at least one a row."""
    cap = max(1, _MAX_BLOCKS // rows)
    return max(1, min(cap, -(-n // (4 * _THREADS))))


def _check(w, g, m, v, scalars, rows: int) -> None:
    for name, t in (("w", w), ("m", m), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if scalars.dtype != torch.float32 or tuple(scalars.shape) != (3,):
        raise ValueError("scalars must be a float32 [3] tensor (ginv, c1, c2)")
    for name, t in (("w", w), ("g", g), ("m", m), ("v", v),
                    ("scalars", scalars)):
        if t.device != w.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and "
                             f"on {w.device}")
        if t is not scalars and t.shape != w.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must match w "
                             f"{tuple(w.shape)}")
    n = w.numel()
    if not 0 < n < 2 ** 31:
        raise ValueError(f"leaf of {n} elements: the kernel takes 1 to 2^31-1")
    if rows < 1 or n % rows or (rows > 1 and (n // rows) % 4) \
            or rows > 65535:
        raise ValueError(f"{rows} rows of a {n}-element leaf: rows must "
                         "divide it into rows of a multiple of 4 elements "
                         "(each row starts 16-byte aligned)")


def lamb_update_(w, g, m, v, scalars: torch.Tensor, *, beta1: float,
                 beta2: float, eps: float, weight_decay: float, lr: float,
                 rows: int = 1) -> torch.Tensor:
    """LAMB Stage 1 + 2 on one leaf, or on a list of leaves that share
    their trust ratios (the norms taken over all of them; a lone leaf is a
    group of one): ``w``, ``m``, ``v`` (float32) updated in place from the
    gradient ``g`` (float32 or bfloat16, read in its own dtype);
    ``scalars`` = [ginv, c1, c2] float32. Each leaf is ``rows`` equal rows
    (its leading dim where ``rows`` > 1), each row with its own ratio.
    Every leaf's stage 1 writes its partial norms into one buffer at its
    own offset (one partial a row on the CPU, ``grid_blocks`` on the
    card), then every leaf's stage 2 reduces the whole buffer. Returns the
    ratios as a [rows] float32 tensor on the leaves' device."""
    hyper = dict(beta1=beta1, beta2=beta2, eps=eps,
                 weight_decay=weight_decay)
    ws, gs, ms, vs = ([x] if isinstance(x, torch.Tensor) else list(x)
                      for x in (w, g, m, v))
    dev = ws[0].device
    if dev.type == "cuda":
        for leaf in zip(ws, gs, ms, vs):
            _check(*leaf, scalars, rows)
        blocks = [grid_blocks(x.numel() // rows, rows) for x in ws]
    elif dev.type == "cpu":
        blocks = [1] * len(ws)
    else:
        raise ValueError(f"unsupported device {dev}")
    nparts = sum(blocks)
    partials = torch.empty(2 * rows * nparts, dtype=torch.float32,
                           device=dev)
    us = [torch.empty_like(x) for x in ws]
    r = torch.empty(rows, dtype=torch.float32, device=dev)
    off = 0
    for leaf, u, b in zip(zip(ws, gs, ms, vs), us, blocks):
        stage1(*leaf, scalars, u, partials[off:], **hyper, rows=rows,
               nparts=nparts)
        off += b
    for x, u in zip(ws, us):
        stage2(x, u, partials, r, lr=lr, rows=rows)
    return r


def lamb_update_shards_(leaves, scalars: torch.Tensor, *, beta1: float,
                        beta2: float, eps: float, weight_decay: float,
                        lr: float, exchange=None) -> list:
    """LAMB Stage 1 + 2 on a data-parallel rank's shards of the ZeRO flat
    leaves: ``leaves`` holds ``(w, g, m, v, rows)`` a flat leaf, each
    tensor this rank's ``[rows, cols]`` columns of it. Every leaf's stage 1
    writes its rows' partial norms into its own region of one buffer,
    ``exchange(buffer, sizes)`` (the mesh's all-reduce: every rank's
    shards are the same size, so the buffer is laid out the same way on
    every rank; ``sizes`` the leaves' regions in order) runs once, and every leaf's stage 2 reduces its region: one
    trust ratio a row over the whole row, all ranks' columns. Returns the
    ratios, one [rows] tensor a leaf."""
    hyper = dict(beta1=beta1, beta2=beta2, eps=eps,
                 weight_decay=weight_decay)
    dev = leaves[0][0].device
    if dev.type == "cuda":
        for w, g, m, v, rows in leaves:
            _check(w, g, m, v, scalars, rows)
        blocks = [grid_blocks(w.numel() // rows, rows)
                  for w, *_, rows in leaves]
    elif dev.type == "cpu":
        blocks = [1] * len(leaves)
    else:
        raise ValueError(f"unsupported device {dev}")
    sizes = [2 * leaf[4] * b for leaf, b in zip(leaves, blocks)]
    partials = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    us = [torch.empty_like(leaf[0]) for leaf in leaves]
    off = 0
    for (w, g, m, v, rows), u, b, n in zip(leaves, us, blocks, sizes):
        stage1(w, g, m, v, scalars, u, partials[off:off + n], **hyper,
               rows=rows, nparts=b)
        off += n
    if exchange is not None:
        exchange(partials, sizes)
    ratios, off = [], 0
    for (w, *_, rows), u, n in zip(leaves, us, sizes):
        r = torch.empty(rows, dtype=torch.float32, device=dev)
        stage2(w, u, partials[off:off + n], r, lr=lr, rows=rows)
        ratios.append(r)
        off += n
    return ratios


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def stage1_flops(w, *args, **kwargs) -> float:
    """FLOPs of one stage-1 call, as its plain version's ops count them
    (``core/characterize.py``): 15 elementwise ops an element, and the two
    squared norms (4 an element)."""
    return 19.0 * w.numel()


def stage2_flops(w, u, partials, *args, rows: int = 1, **kwargs) -> float:
    """FLOPs of one stage-2 call: the reduction of the partials (one add
    a partial), 9 scalar ops a row for the ratio, and the update (2 an
    element)."""
    return 2.0 * w.numel() + partials.numel() + 9.0 * rows


@optrace.kernel_op("lamb_stage1", stage1_flops)
def stage1(w, g, m, v, scalars, u, partials, *, beta1: float, beta2: float,
           eps: float, weight_decay: float, rows: int = 1,
           nparts: Optional[int] = None) -> None:
    """Stage 1 on checked tensors (``lamb_update_`` checks): m, v in place,
    u written, and row r's squared norms of w and u into ``partials[r *
    nparts + b]`` and ``[rows * nparts + r * nparts + b]``, b the CTA (0
    on the CPU, where the plain version runs); ``partials`` starts at this
    leaf's offset in its group's buffer, ``nparts`` (default: this leaf's
    own CTAs a row) is the group's."""
    if w.device.type == "cpu":
        m_new, v_new, u_new = ref.lamb_stage1(
            w, g, m, v, ginv=scalars[0], c1=scalars[1], c2=scalars[2],
            beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
        m.copy_(m_new)
        v.copy_(v_new)
        u.copy_(u_new)
        nparts = 1 if nparts is None else nparts
        wsq, usq = ref.sq_norms(w, u, rows)
        partials[:rows * nparts:nparts] = wsq
        partials[rows * nparts:2 * rows * nparts:nparts] = usq
        return
    n = w.numel() // rows
    blocks = grid_blocks(n, rows)
    fn = _build.bind(_LIB, "lamb_stage1", 7, 5, 6)
    err = fn(w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
             scalars.data_ptr(), u.data_ptr(), partials.data_ptr(), n, rows,
             blocks, blocks if nparts is None else nparts,
             int(g.dtype == torch.float32), beta1, 1.0 - beta1, beta2,
             1.0 - beta2, eps, weight_decay, _stream(w))
    _build.check(err, "lamb_stage1")
    LAUNCHES["lamb_stage1"] += 1


@optrace.kernel_op("lamb_stage2", stage2_flops)
def stage2(w, u, partials, r, *, lr: float, rows: int = 1) -> None:
    """Stage 2: each row's trust ratio into ``r`` [rows], and w -= lr * r
    * u in place. The ratio comes from the group's whole buffer of stage
    1's partials, ``2 * rows * nparts`` of them: row r reduces the
    ``nparts`` w^2 sums at ``partials[r * nparts]`` and the u^2 sums
    ``rows * nparts`` further on."""
    nparts = partials.numel() // (2 * rows)
    if w.device.type == "cpu":
        wsq, usq = partials.view(2, rows, nparts).sum(2)
        ratio = ref.ratio(wsq, usq)
        w.copy_(ref.lamb_stage2(w, u, lr=lr,
                                r=ratio[0] if rows == 1 else ratio))
        r.copy_(ratio)
        return
    fn = _build.bind(_LIB, "lamb_stage2", 4, 4, 1)
    err = fn(w.data_ptr(), u.data_ptr(), partials.data_ptr(), r.data_ptr(),
             w.numel() // rows, rows, grid_blocks(w.numel() // rows, rows),
             nparts, lr, _stream(w))
    _build.check(err, "lamb_stage2")
    LAUNCHES["lamb_stage2"] += 1
