"""Token-choice MoE with sort-based capacity dispatch (drop on overflow).
Counterpart of ``repro.models.moe`` (``capacity_per_row``, ``init_moe``,
``_route_indices``, ``apply_moe``), its serving tensor parallelism
included: with a process ``group`` each rank owns ``E / tp`` contiguous
experts (the leading dim of its ``experts`` leaves), the routing is
replicated, each rank dispatches, runs and combines only the capacity slots
of its experts, and the partial combines meet in one fp32 ``all_reduce``,
the layer's one collective (JAX's ``psum``).

The routing is JAX's, per batch row: softmax of the fp32 router logits,
top-k, the weights renormalised, the ``S * k`` choices sorted by expert
with a *stable* sort (so a chunk's trailing padding never displaces a real
token), and the ``c``-th choice of an expert keeps capacity slot ``c`` if
``c`` is below the capacity (``eff_capacity`` may tighten it). Every
expert then runs its GEMMs on all its capacity slots, filled or not (the
padded dispatch JAX's einsums compute), and each token sums its kept
choices' outputs, weighted, in ascending expert order: the order of JAX's
sorted scatter-add, in the activations' dtype.

Nothing here synchronises with the host or depends on the data for its
shapes, so a decode step that runs a MoE can be captured in a CUDA graph:
the dispatch and the combine are gathers (each capacity slot finds the
choice that fills it through the inverse of the sort), never scatter-adds,
whose float atomics on the card would sum in a varying order and break
the bitwise contracts (N steps against one, fused against unfused, two
calls against each other).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..configs.base import ArchConfig, MoEConfig
from ..core.optrace import scope
from ..parallel import collectives
from .layers import Params, dense_init, gelu, silu


def capacity_per_row(seq: int, moe: MoEConfig) -> int:
    """Capacity slots of each expert for a row of ``seq`` tokens."""
    return max(1, math.ceil(seq * moe.top_k * moe.capacity_factor
                            / moe.num_experts))


def init_moe(gen: torch.Generator, arch: ArchConfig, device,
             dtype: torch.dtype) -> Params:
    """Random weights with the distributions of JAX's ``init_moe``: the
    router N(0, 1/d) (made in fp32, then cast to ``dtype`` as the JAX serve
    casts every leaf), the experts truncated normals cut at +-2 times
    1/sqrt(fan-in), the shared experts a dense init of
    ``expert_ff * num_shared_experts`` columns."""
    moe = arch.moe
    d = arch.d_model
    eff = moe.expert_ff or arch.d_ff

    def trunc(shape, std):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                    generator=gen)
        return t.mul_(std).to(dtype)

    router = torch.empty((d, moe.num_experts), dtype=torch.float32,
                         device=device)
    router.normal_(0.0, 1.0, generator=gen)
    e = moe.num_experts
    p: Params = {
        "router": (router * (1.0 / math.sqrt(d))).to(dtype),
        "experts": {"w1": trunc((e, d, eff), 1.0 / math.sqrt(d)),
                    "w3": trunc((e, d, eff), 1.0 / math.sqrt(d)),
                    "w2": trunc((e, eff, d), 1.0 / math.sqrt(eff))}}
    if moe.num_shared_experts:
        sf = eff * moe.num_shared_experts
        p["shared"] = {"w1": dense_init(gen, d, sf, device, dtype),
                       "w3": dense_init(gen, d, sf, device, dtype),
                       "w2": dense_init(gen, sf, d, device, dtype)}
    return p


def _route(logits: torch.Tensor, moe: MoEConfig, capacity: int,
           eff_capacity: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Routing of logits [..., S, E] (fp32), every leading index a row of
    its own: the top-k ``ids`` and ``weights`` [..., S, k], the sort
    ``order`` [..., S*k] of the flattened choices by expert, and in that
    order the source token ``st``, weight ``sw``, capacity ``slot`` (the
    overflow sentinel ``E * capacity`` where dropped) and ``valid``."""
    *lead, s, e = logits.shape
    k = moe.top_k
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.topk(probs, k, dim=-1)
    top_w = top_w / torch.clamp_min(top_w.sum(dim=-1, keepdim=True), 1e-9)
    flat_e = top_ids.reshape(*lead, s * k)
    flat_w = top_w.reshape(*lead, s * k)
    n = torch.arange(s * k, device=dev)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(-1, order)
    st = order // k                         # flat_t = arange(S*k) // k
    sw = flat_w.gather(-1, order)
    experts = torch.arange(e, device=dev).expand(*lead, e).contiguous()
    start = torch.searchsorted(se, experts, side="left")
    pos = n - start.gather(-1, se)
    limit = capacity if eff_capacity is None \
        else min(capacity, int(eff_capacity))
    valid = pos < limit
    slot = torch.where(valid, se * capacity + pos,
                       torch.full_like(se, e * capacity))
    return {"ids": top_ids, "weights": top_w, "order": order, "st": st,
            "sw": sw, "slot": slot, "valid": valid}


def _route_indices(logits: torch.Tensor, moe: MoEConfig, capacity: int,
                   eff_capacity: Optional[int] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """JAX's per-row routing index math: logits [S, E] fp32 -> (st [S*k]
    source token ids, sw [S*k] weights, slot [S*k] capacity-slot ids with
    the overflow sentinel, valid [S*k]), in stable expert order.
    ``capacity`` sizes the dispatch buffer; ``eff_capacity`` (a host int)
    may tighten the drop threshold below it: the chunked prefill passes
    the full prompt's capacity, so a prompt served in one padded chunk
    drops what the static engine's full-prompt dispatch drops."""
    r = _route(logits, moe, capacity, eff_capacity)
    return r["st"], r["sw"], r["slot"], r["valid"]


def apply_moe(arch: ArchConfig, p: Params, x: torch.Tensor,
              eff_capacity: Optional[int] = None, aux_loss: bool = True,
              group=None, data_group=None, par=None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x [B, S, D] -> (y [B, S, D], the Switch load-balancing loss, fp32
    scalar, differentiable through the router's probabilities: the
    training forward adds it to the loss, as JAX's; None when
    ``aux_loss`` is False, as the serving paths ask: JAX's jitted serving
    steps drop it as dead code). Each batch row
    routes on its own with ``capacity_per_row(S)`` slots an expert, so a
    decode step ([slots, 1, D]) gives every slot one slot an expert and
    drops nothing. With ``group`` (serving tensor parallelism) the
    rank's ``experts`` hold its ``E / tp`` experts and its ``shared``
    experts are Megatron shards; the routed and shared partial sums are
    reduced in one fp32 ``all_reduce``. With a ``data_group`` (x this
    rank's rows of a data-parallel batch) the Switch loss is the whole
    batch's: E * sum_e f_e * P_e is not linear in the batch, so the
    router's counts and probability sums are summed over the group
    (``collectives.global_sum``, one ``all_reduce``) before it; the
    dispatch stays the rank's own (the capacity is a row's). On a training
    mesh with a model axis (``par``) see ``_train_moe``."""
    with scope("moe"):
        if par is not None and par.model is not None:
            return _train_moe(arch, p, x, par, data_group)
        return _apply_moe(arch, p, x, eff_capacity, aux_loss, group,
                          data_group)


def _routed(arch: ArchConfig, p: Params, x: torch.Tensor,
            r: Dict[str, torch.Tensor], cap: int,
            rank: Optional[int] = None) -> torch.Tensor:
    """The routed experts' combine [B, S, D] for routing ``r`` over x [B,
    S, D]: with ``rank`` the experts ``p`` holds are that rank's ``E_l``
    contiguous ones (the others' slots fold into the overflow sentinel),
    so the combine is the rank's partial sum."""
    b, s, d = x.shape
    k = arch.moe.top_k
    e = p["experts"]["w1"].shape[0]     # the experts this rank owns
    dev = x.device
    n = s * k
    if rank is not None:
        # rebase the global capacity slots onto this rank's experts; the
        # slots of other ranks' experts fold into the overflow sentinel,
        # so they neither dispatch nor combine here
        slot = r["slot"] - rank * e * cap
        valid = r["valid"] & (slot >= 0) & (slot < e * cap)
        r = dict(r, slot=torch.where(valid, slot, e * cap), valid=valid)

    # dispatch: the sorted choice that fills each capacity slot (kept
    # choices hold distinct slots; dropped ones all hit the sentinel,
    # which is cut off), then a gather of its token's row
    src = torch.full((b, e * cap + 1), -1, dtype=torch.int64, device=dev)
    src.scatter_(1, r["slot"], torch.arange(n, device=dev).expand(b, n))
    src = src[:, :-1]
    filled = src >= 0
    tok = r["st"].gather(1, src.clamp_min(0))
    rows = x.gather(1, tok[..., None].expand(b, e * cap, d))
    slots = torch.where(filled[..., None], rows, torch.zeros_like(rows))
    xs = slots.view(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)

    w = p["experts"]
    act = silu if arch.mlp == "swiglu" else gelu
    h = act(torch.bmm(xs, w["w1"].to(x.dtype)))
    if arch.mlp == "swiglu":
        h = h * torch.bmm(xs, w["w3"].to(x.dtype))
    out = torch.bmm(h, w["w2"].to(x.dtype))                   # [E, B*C, D]
    out = out.view(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)
    out = torch.cat([out, out.new_zeros((b, 1, d))], dim=1)  # + sentinel

    # combine: each token's k choices in ascending expert order, through
    # the inverse of the sort, summed one after another
    inv = torch.empty_like(r["order"])
    inv.scatter_(1, r["order"], torch.arange(n, device=dev).expand(b, n))
    _, perm = torch.sort(r["ids"], dim=-1)      # a token's experts differ
    u = (torch.arange(s, device=dev)[:, None] * k + perm).reshape(b, n)
    i = inv.gather(1, u)
    slot = r["slot"].gather(1, i)
    wt = (r["sw"] * r["valid"]).gather(1, i).to(x.dtype)
    contrib = out.gather(1, slot[..., None].expand(b, n, d)) * wt[..., None]
    contrib = contrib.view(b, s, k, d)
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    return y


def _shared(p: Params, x: torch.Tensor) -> torch.Tensor:
    sh = p["shared"]
    hs = silu(x @ sh["w1"].to(x.dtype)) * (x @ sh["w3"].to(x.dtype))
    return hs @ sh["w2"].to(x.dtype)


def _switch_loss(moe: MoEConfig, logits: torch.Tensor, groups,
                 tokens: int) -> torch.Tensor:
    """E * sum_e f_e * P_e over ``tokens`` tokens, of which ``logits``
    [..., E] hold this rank's; the counts and probability sums summed over
    each group of ``groups`` (``global_sum``) where there are any."""
    probs = torch.softmax(logits, dim=-1)
    top1 = probs.argmax(dim=-1)
    onehot = torch.nn.functional.one_hot(top1, moe.num_experts).float()
    lead = tuple(range(logits.dim() - 1))
    if not groups:
        f = onehot.mean(dim=lead)
        pmean = probs.mean(dim=lead)
    else:
        sums = torch.cat([onehot.sum(dim=lead), probs.sum(dim=lead)])
        for g in groups:
            sums = collectives.global_sum(sums, g)
        f, pmean = (sums / tokens).split(moe.num_experts)
    return moe.num_experts * (f * pmean).sum() * moe.aux_loss_weight


def _apply_moe(arch: ArchConfig, p: Params, x: torch.Tensor,
               eff_capacity: Optional[int], aux_loss: bool, group=None,
               data_group=None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    moe = arch.moe
    b, s, d = x.shape
    cap = capacity_per_row(s, moe)
    # the router's product in fp32 on the fp32 values of its (model dtype)
    # weights, as JAX computes x.astype(f32) @ router; TF32 stays off
    # (PyTorch's default for matmuls), so it is a true fp32 product
    logits = x.float() @ p["router"].float()                  # [B, S, E]
    r = _route(logits, moe, cap, eff_capacity)
    y = _routed(arch, p, x, r, cap,
                None if group is None else dist.get_rank(group))
    if "shared" in p:
        y = y + _shared(p, x)
    if group is not None:
        y32 = y.float()
        dist.all_reduce(y32, group=group)
        y = y32.to(x.dtype)
    if not aux_loss:
        return y, None
    groups = [] if data_group is None else [data_group]
    tokens = b * s * (1 if data_group is None
                      else dist.get_world_size(data_group))
    return y, _switch_loss(moe, logits, groups, tokens)


def _train_moe(arch: ArchConfig, p: Params, x: torch.Tensor, par,
               data_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer on a training mesh with a model axis (JAX's
    ``_apply_moe_inner`` under ``make_rules``). Each row is routed whole,
    so the capacity and drops are a whole row's as in JAX: under sequence
    parallelism the rank's rows are gathered first (``par.enter``), and
    the router's product runs on the whole row on every rank.

    - Expert parallelism (``par.experts``): the rank holds E / tp
      experts, dispatches and combines their capacity slots only, and its
      partial combine plus its Megatron share of the shared experts
      leaves the region in one collective (``par.exit``). Without
      sequence parallelism the routing reads the logits through
      ``copy_to``, so their gradient, a partial sum over the ranks'
      experts, is summed.
    - Without it every rank holds every expert and computes the whole
      combine; under sequence parallelism it keeps its rows of it (the
      gradient of the rest stays with the other ranks), and only the
      shared experts' partial sum is reduced.

    The Switch loss is the whole batch's: under sequence parallelism each
    rank counts its own rows and the sums meet over the data and model
    groups (``global_sum``: each rank's gradient is its rows' share);
    otherwise every model rank counts every row, over the data group only.
    """
    moe = arch.moe
    seq = par.seq
    xf = par.enter(x) if seq else x                         # [B, S, D]
    b, s, d = xf.shape
    cap = capacity_per_row(s, moe)
    logits = xf.float() @ p["router"].float()
    groups = [g for g in (data_group,) if g is not None]
    tokens = b * s * par.dp
    if seq:
        s0, s1 = par.rows(s)
        aux = _switch_loss(moe, logits[:, s0:s1], groups + [par.model],
                           tokens)
    else:
        aux = _switch_loss(moe, logits, groups, tokens)
    if par.experts:
        if not seq:
            xf = collectives.copy_to(xf, par.model)
            logits = collectives.copy_to(logits, par.model)
        r = _route(logits, moe, cap)
        y = _routed(arch, p, xf, r, cap, par.mrank)
        if "shared" in p:
            y = y + _shared(p, xf)
        return par.exit(y), aux
    routed = _routed(arch, p, xf, _route(logits, moe, cap), cap)
    if seq:
        routed = routed[:, s0:s1]
    if "shared" not in p:
        return routed, aux
    ys = _shared(p, xf if seq else collectives.copy_to(xf, par.model))
    return par.exit(ys) + routed, aux
