"""LAMB, as the paper's Fig. 3 (counterpart of ``repro.optim.lamb`` with
``zero1=False``, the layout ``launch/train.py`` uses):

  global      g' = ||g||                    (fp32, every leaf)
  Stage 1     m = b1 m + (1-b1) g/g';  v = b2 v + (1-b2) (g/g')^2
              u = m c1 / (sqrt(v c2) + eps) + wd w
  Stage 2     r = ||w|| / ||u|| per layer;  w <- w - lr r u

The trust ratios follow JAX's ``_layer_axes``: one per (layer, expert)
row. The port keeps one tensor per layer, so a leaf takes one ratio, a MoE
expert leaf ``[E, ...]`` one an expert (``trust_layout``), and a leaf of
whisper's encoder one shared with the same leaf of every other encoder
layer: JAX stacks the encoder's layers into one leaf whose layer axis
``_layer_axes`` does not mark (it marks ``blocks`` only). With master
weights (paper section 3.2.1) the optimizer holds an fp32 copy of every
parameter, updates it, and casts it into the bf16 model parameter.
``use_fused_kernel`` routes Stage 1 + 2 through the two CUDA kernels of
``kernels.fused_lamb``, one launch of each a leaf; otherwise they run as
plain PyTorch (``lamb_stage12``). Either takes a group of leaves that
share their ratios, a lone leaf a group of one. State and parameters are
updated in place under ``torch.no_grad()`` (JAX returns new arrays and
donates the old ones).

With ``zero1`` (JAX's default) ``m``, ``v`` and ``master`` are held in the
ZeRO flat layout (``optim.zero``): one ``[rows, padded]`` fp32 leaf a
group of leaves that share their ratios, a row a ratio, or with a data
group a rank's ``[rows, padded / dp]`` columns of it (``zero.Plan``). The
rank updates only its columns: each row's squared norms are summed across
the ranks (one ``all_reduce`` of every leaf's partials between Stage 1 and
Stage 2), so the trust ratio stays one a row over the whole row; the
padding columns (g = m = v = w = 0, so u = 0) add nothing to a norm. The
new parameters reach every rank through the plan's ``all_gather``. On a
mesh with a model axis the global norm sums over the whole mesh, a leaf
every model rank holds counted once, and a row's partials are summed over
the ranks that hold other parts of that row (``_exchange``: the data axis,
and the model axis for a tensor-parallel leaf), so a row's ratio is the
whole (layer, expert) row's however the leaf is split.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from .. import tree
from ..core.optrace import scope
from ..kernels.fused_lamb import ops as fused
from ..kernels.fused_lamb import ref as plain
from ..parallel import collectives
from . import grad as grad_lib
from . import zero


@dataclasses.dataclass(frozen=True)
class LambConfig:
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-6
    weight_decay: float = 0.01
    zero1: bool = True
    use_fused_kernel: bool = False
    master_weights: bool = True


def init(cfg: LambConfig, params, plan: Optional[zero.Plan] = None) -> Dict:
    """``{m, v}`` fp32 zeros shaped like the params, ``step`` 0 and, with
    master weights, ``master``: an fp32 copy of every parameter. With
    ``zero1`` the three in ``plan``'s flat layout (default: one device),
    this rank's columns of each flat leaf."""
    first = tree.leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if cfg.zero1:
        plan = plan or zero.Plan(params)
        state = {"m": plan.zeros(first.device),
                 "v": plan.zeros(first.device), "step": step}
        if cfg.master_weights:
            state["master"] = plan.state(plan.shards(params))
        return state

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    state = {"m": tree.map(zeros, params), "v": tree.map(zeros, params),
             "step": step}
    if cfg.master_weights:
        state["master"] = tree.map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def trust_layout(params) -> List[Tuple[int, Optional[tuple]]]:
    """For each leaf of ``params`` in ``tree.leaves`` order, ``(rows,
    group)``: the leaf's trust ratios are one a row of its leading
    ``rows`` (a MoE expert leaf's experts; else 1, the whole leaf), and
    leaves with the same ``group`` (not None) share one ratio (a leaf of
    whisper's encoder stack, across its layers, where it has more than
    one): JAX's ``_layer_axes``, the rows of ``zero.flat_leaves``."""
    out = [None] * len(tree.leaves(params))
    for u in zero.flat_leaves(params)[1]:
        for i in u.members:
            out[i] = (u.rows, u.path if u.spans else None)
    return out


def update(cfg: LambConfig, grads, state: Dict, params,
           plan: Optional[zero.Plan] = None) -> Tuple:
    """One LAMB step, in place on ``params`` and ``state``; returns them.
    With ``zero1`` the state is in ``plan``'s layout and ``grads`` either
    this rank's flat gradient shards (a list, one a flat leaf: the
    trainer's) or, on one device, gradients shaped like the params."""
    with scope("lamb"):
        if cfg.zero1:
            return _update_zero(cfg, grads, state, params,
                                plan or zero.Plan(params))
        return _update(cfg, grads, state, params)


def _bias_corrections(cfg, state: Dict):
    state["step"].add_(1)
    t = state["step"].float()
    return (1.0 / (1.0 - torch.pow(cfg.beta1, t)),
            1.0 / (1.0 - torch.pow(cfg.beta2, t)))


@torch.no_grad()
def _update_zero(cfg: LambConfig, grads, state: Dict, params,
                 plan: zero.Plan) -> Tuple:
    c1, c2 = _bias_corrections(cfg, state)
    gs = plan.grad_shards(grads)
    norm = grad_lib.global_norm(gs, plan.norm_group,
                                plan.weights(gs[0].device))
    ginv = 1.0 / torch.clamp_min(norm, 1e-12)
    hyper = dict(beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps,
                 weight_decay=cfg.weight_decay, lr=cfg.learning_rate)
    ws = tree.leaves(state["master"]) if "master" in state \
        else plan.shards(params)
    ms, vs = tree.leaves(state["m"]), tree.leaves(state["v"])
    rows = [u.rows for u in plan.units]
    exchange = None if plan.norm_group is None else \
        (lambda buf, sizes: _exchange(plan, buf, sizes))
    if cfg.use_fused_kernel:
        fused.lamb_update_shards_(
            list(zip(ws, gs, ms, vs, rows)),
            torch.stack([ginv, c1, c2]).float(), exchange=exchange, **hyper)
    else:
        hyper.pop("lr")
        new = [plain.lamb_stage1(w, g, m, v, ginv=ginv, c1=c1, c2=c2,
                                 **hyper) for w, g, m, v in zip(ws, gs, ms,
                                                                 vs)]
        sq = torch.cat([torch.cat(plain.sq_norms(w, u, r))
                        for w, (_, _, u), r in zip(ws, new, rows)])
        if exchange is not None:
            exchange(sq, [2 * r for r in rows])
        off = 0
        for w, m, v, (m_new, v_new, u), r in zip(ws, ms, vs, new, rows):
            ratio = plain.ratio(sq[off:off + r], sq[off + r:off + 2 * r])
            off += 2 * r
            w.copy_(plain.lamb_stage2(w, u, lr=cfg.learning_rate, r=ratio))
            m.copy_(m_new)
            v.copy_(v_new)
    plan.gather_params_(params, ws)
    return params, state


def _exchange(plan: zero.Plan, buf: torch.Tensor, sizes: List[int]) -> None:
    """Sum the partial squared norms ``buf`` (each flat leaf's region
    ``sizes`` long, in ``plan.units`` order) over the ranks that hold
    other parts of the same rows: the data group (the ZeRO columns and
    FSDP slices), then, on a mesh with a model axis, the model group for
    the leaves the model axis splits within their rows (``plan.row_sum``;
    the other regions keep their own values: a leaf every model rank
    holds whole, or an expert-parallel leaf, whose model ranks hold other
    rows)."""
    if plan.group is not None:
        collectives.all_reduce(buf, plan.group)
    if plan.row_sum is None:
        return
    keep = plan.weights(buf.device, sizes, "row_sum")
    part = buf * keep
    collectives.all_reduce(part, plan.model_group)
    buf.copy_(part + buf * (1.0 - keep))


@torch.no_grad()
def _update(cfg: LambConfig, grads, state: Dict, params) -> Tuple:
    c1, c2 = _bias_corrections(cfg, state)
    gn = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                      for g in tree.leaves(grads)])
    ginv = 1.0 / torch.clamp_min(torch.linalg.vector_norm(gn), 1e-12)
    scalars = torch.stack([ginv, c1, c2]).float()
    hyper = dict(beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps,
                 weight_decay=cfg.weight_decay, lr=cfg.learning_rate)
    ps = tree.leaves(params)
    masters = tree.leaves(state["master"]) if "master" in state \
        else [None] * len(ps)
    ws = [w if w is not None else (p if p.dtype == torch.float32
                                   else p.float())
          for p, w in zip(ps, masters)]
    leaves = list(zip(ws, tree.leaves(grads), tree.leaves(state["m"]),
                      tree.leaves(state["v"])))
    layout = trust_layout(params)
    groups: Dict[object, List[int]] = {}        # a lone leaf: a group of one
    for i, (_, group) in enumerate(layout):
        groups.setdefault(i if group is None else group, []).append(i)
    for idx in groups.values():
        w, g, m, v = ([leaves[i][k] for i in idx] for k in range(4))
        rows = layout[idx[0]][0]
        if cfg.use_fused_kernel:
            fused.lamb_update_(w, [x.contiguous() for x in g], m, v,
                               scalars, rows=rows, **hyper)
            continue
        w_new, m_new, v_new, _ = plain.lamb_stage12(
            w, g, m, v, ginv=ginv, c1=c1, c2=c2, rows=rows, **hyper)
        for dst, src in zip(w + m + v, w_new + m_new + v_new):
            dst.copy_(src)
    for p, w in zip(ps, ws):
        if w is not p:
            p.copy_(w)          # the cast into the model's dtype
    return params, state
