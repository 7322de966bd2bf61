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
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from .. import tree
from ..core.optrace import scope
from ..kernels.fused_lamb import ops as fused
from ..kernels.fused_lamb import ref as plain


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


def _check(cfg: LambConfig) -> None:
    if cfg.zero1:
        raise NotImplementedError("LAMB zero1=True: the ZeRO layout not "
                                  "ported (launch/train.py passes False)")


def init(cfg: LambConfig, params) -> Dict:
    """``{m, v}`` fp32 zeros shaped like the params, ``step`` 0 and, with
    master weights, ``master``: an fp32 copy of every parameter."""
    _check(cfg)

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = tree.leaves(params)[0]
    state = {"m": tree.map(zeros, params), "v": tree.map(zeros, params),
             "step": torch.zeros((), dtype=torch.int32, device=first.device)}
    if cfg.master_weights:
        state["master"] = tree.map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _paths(t, prefix + (i,))
    else:
        yield prefix, tree


def trust_layout(params) -> List[Tuple[int, Optional[tuple]]]:
    """For each leaf of ``params`` in ``tree.leaves`` order, ``(rows,
    group)``: the leaf's trust ratios are one a row of its leading
    ``rows`` (a MoE expert leaf's experts; else 1, the whole leaf), and
    leaves with the same ``group`` (not None) share one ratio (a leaf of
    whisper's encoder stack, across its layers, where it has more than
    one)."""
    stacked = len(params.get("enc_blocks", ())) > 1
    out = []
    for path, leaf in _paths(params):
        rows = leaf.shape[0] if "experts" in path[:-1] and leaf.dim() >= 2 \
            else 1
        group = path[:1] + path[2:] \
            if stacked and path[0] == "enc_blocks" else None
        out.append((rows, group))
    return out


def update(cfg: LambConfig, grads, state: Dict, params) -> Tuple:
    """One LAMB step, in place on ``params`` and ``state``; returns them."""
    with scope("lamb"):
        return _update(cfg, grads, state, params)


@torch.no_grad()
def _update(cfg: LambConfig, grads, state: Dict, params) -> Tuple:
    _check(cfg)
    state["step"].add_(1)
    t = state["step"].float()
    c1 = 1.0 / (1.0 - torch.pow(cfg.beta1, t))
    c2 = 1.0 / (1.0 - torch.pow(cfg.beta2, t))
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
