"""Plain PyTorch version of the fused LAMB kernels (the paper's Fig. 3,
Stage 1 + Stage 2). Counterpart of ``repro.kernels.fused_lamb.ref``.

The trust ratio is one per layer, as Fig. 3 and ``repro.optim.lamb``
reduce it: the port keeps one tensor per layer, so a leaf is a layer,
except a MoE expert leaf ``[E, ...]``, whose ``E`` rows (one an expert)
take a ratio each, as JAX's ``_layer_axes`` gives them (``rows``), and
leaves that JAX stacks into one (whisper's encoder layers), which share
theirs (``lamb_stage12`` of lists). (The JAX package's Pallas path
reduces per last-axis row instead; the port follows the reference.)
``ginv``, ``c1`` and ``c2`` may be Python floats or 0-d tensors on the
leaf's device.
"""
from __future__ import annotations

from typing import Tuple

import torch


def lamb_stage1(w: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, *, ginv, c1, c2, beta1: float, beta2: float,
                eps: float, weight_decay: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (m', v', u): the update direction before the trust ratio."""
    gn = g.float() * ginv
    m_new = beta1 * m + (1.0 - beta1) * gn
    v_new = beta2 * v + (1.0 - beta2) * torch.square(gn)
    u = (m_new * c1) / (torch.sqrt(v_new * c2) + eps) + weight_decay * w
    return m_new, v_new, u


def sq_norms(w: torch.Tensor, u: torch.Tensor, rows: int = 1
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The squared norms of ``w`` and ``u`` over each of the leaf's
    ``rows`` rows (its leading ``rows`` elements' blocks) -> two [rows]."""
    return (torch.sum(torch.square(w.reshape(rows, -1)), dim=1),
            torch.sum(torch.square(u.reshape(rows, -1)), dim=1))


def ratio(wsq: torch.Tensor, usq: torch.Tensor) -> torch.Tensor:
    """``||w|| / ||u||`` from the squared norms (1 where either is 0)."""
    wn, un = torch.sqrt(wsq), torch.sqrt(usq)
    return torch.where((wn > 0) & (un > 0), wn / torch.clamp_min(un, 1e-30),
                       torch.ones_like(wn))


def trust_ratio(w: torch.Tensor, u: torch.Tensor,
                rows: int = 1) -> torch.Tensor:
    """``||w|| / ||u||`` over each row of the leaf -> [rows] (a 0-d
    tensor for ``rows`` 1, the whole leaf)."""
    r = ratio(*sq_norms(w, u, rows))
    return r[0] if rows == 1 else r


def lamb_stage2(w: torch.Tensor, u: torch.Tensor, *, lr: float,
                r: torch.Tensor) -> torch.Tensor:
    """w' = w - lr * r * u, ``r`` a scalar or one a row."""
    if r.dim() == 0:
        return w - lr * r * u
    rs = r.reshape((-1,) + (1,) * (w.dim() - 1))
    return w - lr * rs * u


def lamb_stage12(w, g, m, v, *, ginv, c1, c2, beta1: float, beta2: float,
                 eps: float, weight_decay: float, lr: float, rows: int = 1
                 ) -> Tuple:
    """The full Fig. 3 update -> (w', m', v', trust ratio): of one leaf,
    one ratio a row of ``rows``; or, given lists of leaves, of leaves that
    share their ratios (each leaf's squared norms a row, then summed across
    the leaves), w', m' and v' lists."""
    one = isinstance(w, torch.Tensor)
    ws, gs, ms, vs = ([x] if one else list(x) for x in (w, g, m, v))
    new = [lamb_stage1(*a, ginv=ginv, c1=c1, c2=c2, beta1=beta1,
                       beta2=beta2, eps=eps, weight_decay=weight_decay)
           for a in zip(ws, gs, ms, vs)]
    sq = [sq_norms(a, u, rows) for a, (_, _, u) in zip(ws, new)]
    r = ratio(*(torch.stack([q[k] for q in sq], dim=1).sum(1)
                for k in (0, 1)))
    r = r[0] if rows == 1 else r
    w_new = [lamb_stage2(a, u, lr=lr, r=r) for a, (_, _, u) in zip(ws, new)]
    if one:
        return w_new[0], new[0][0], new[0][1], r
    return w_new, [x[0] for x in new], [x[1] for x in new], r
