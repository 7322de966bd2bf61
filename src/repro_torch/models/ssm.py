"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060): the mixer's init,
the chunked SSD scan, the one-token update, the full-sequence block, the
static engine's prefill (``extend_mamba``) and the continuous engine's
per-slot decode state. Counterpart of
``repro.models.ssm``; parameter names and shapes are the same
(``in_proj [D, 2*inner + 2*G*N + H]``, ``conv [W, inner + 2*G*N]``,
``A_log``, ``D``, ``dt_bias [H]``, ``norm_scale [inner]``,
``out_proj [inner, D]``).

The dtype promotion is JAX's, step by step, because a served model has every
leaf in the model dtype (the JAX serve casts all params to ``arch.dtype``):
``a = -exp(A_log)`` is taken in the param dtype, ``dt`` is upcast before the
bias is added, the conv output's SiLU runs in the model dtype, and the skip
is ``y + x * D.to(y.dtype)``. All decay and cumulative-sum math is fp32.

The JAX serving layers return new state pools; here the per-slot pools are
updated in place, as the attention layers write their K/V pages in place.
The mixer's epilogue is ``kernels.fused_layernorm.ops.gated_rmsnorm``: its
plain version for CPU tensors, the CUDA kernel for tensors on the card.

On a training mesh with a model axis (``apply_mamba``'s ``par``) a rank
runs the mixer on its H / tp heads (``_rank_mamba``), holding 1 / tp of
every segment of ``in_proj`` and ``conv`` (``parallel.sharding.
_mamba_columns``) and its rows of ``out_proj``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..core.optrace import scope
from ..kernels.fused_layernorm import ops as ln_ops
from .layers import Params, dense_init, silu, softplus


def inner_dim(arch: ArchConfig) -> int:
    return arch.ssm.expand * arch.d_model


def num_ssm_heads(arch: ArchConfig) -> int:
    return inner_dim(arch) // arch.ssm.head_dim


def conv_channels(arch: ArchConfig) -> int:
    s = arch.ssm
    return inner_dim(arch) + 2 * s.ngroups * s.state_dim


# ------------------------------------------------------------------- init ---

def init_mamba(gen: torch.Generator, arch: ArchConfig, device,
               dtype: torch.dtype) -> Params:
    """Random mixer weights with the JAX init's distributions (not its
    bits): ``A_log = log U[1, 16]``, ``dt_bias`` the inverse softplus of
    ``dt = exp(U[log 1e-3, log 1e-1])``, ``D`` and ``norm_scale`` ones.
    Every leaf is made in fp32 and cast to ``dtype``, as the JAX serve
    casts its params to the model dtype."""
    s = arch.ssm
    d, inner, h = arch.d_model, inner_dim(arch), num_ssm_heads(arch)
    proj_out = 2 * inner + 2 * s.ngroups * s.state_dim + h

    def uniform(n, lo, hi):
        t = torch.empty((n,), dtype=torch.float32, device=device)
        return t.uniform_(lo, hi, generator=gen)

    in_proj = dense_init(gen, d, proj_out, device, dtype)
    conv = torch.empty((s.conv_width, conv_channels(arch)),
                       dtype=torch.float32, device=device)
    conv.normal_(0.0, 1.0, generator=gen)
    a_log = torch.log(uniform(h, 1.0, 16.0))
    dt = torch.exp(uniform(h, math.log(1e-3), math.log(1e-1)))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    return {
        "in_proj": in_proj,
        "conv": (conv * (1.0 / s.conv_width)).to(dtype),
        "A_log": a_log.to(dtype),
        "D": torch.ones((h,), dtype=dtype, device=device),
        "dt_bias": dt_bias.to(dtype),
        "norm_scale": torch.ones((inner,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, inner, d, device, dtype),
    }


# ------------------------------------------------------------ SSD chunked ---

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., Q] -> [..., Q, Q] lower-triangular pairwise sums:
    out[i, j] = sum(x[j+1 .. i]), -inf above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD over full sequences, in fp32.

    x [B, S, H, P] inputs per head; dt [B, S, H] positive step sizes
    (already softplus'd); a [H] negative decay rates; b, c [B, S, G, N]
    input and output projections, shared by the H/G heads of a group
    -> (y [B, S, H, P] in x's dtype, final_state [B, H, N, P] fp32).
    """
    bsz, seq, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    assert seq % chunk == 0, (seq, chunk)
    nc = seq // chunk
    rep = h // g

    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h).float()
    bc = b.reshape(bsz, nc, chunk, g, n).float()
    cc = c.reshape(bsz, nc, chunk, g, n).float()
    da = dtc * a[None, None, None, :]                         # [B,nc,Q,H]
    xdt = xc.float() * dtc[..., None]                         # [B,nc,Q,H,P]

    # intra-chunk (diagonal) term: attention-like with a decay mask
    lmat = torch.exp(_segsum(torch.movedim(da, -1, 2)))       # [B,nc,H,Q,Q]
    scores = torch.einsum("bzqgn,bzkgn->bzgqk", cc, bc)       # [B,nc,G,Q,Q]
    scores = torch.repeat_interleave(scores, rep, dim=2)      # [B,nc,H,Q,Q]
    y_diag = torch.einsum("bzhqk,bzkhp->bzqhp", scores * lmat, xdt)

    # chunk states: S_z = sum_k decay_to_end[k] * b[k] (x dt)[k]
    cum = torch.cumsum(da, dim=2)                             # [B,nc,Q,H]
    total = cum[:, :, -1:, :]                                 # [B,nc,1,H]
    decay_to_end = torch.exp(total - cum)
    bh = torch.repeat_interleave(bc, rep, dim=3)              # [B,nc,Q,H,N]
    states = torch.einsum("bzqhn,bzqhp->bzhnp",
                          bh * decay_to_end[..., None], xdt)

    # inter-chunk recurrence over the chunks (sequential, cheap); the
    # state entering each chunk is kept
    chunk_decay = torch.exp(total[:, :, 0, :])                # [B,nc,H]
    s_run = (initial_state.float() if initial_state is not None else
             torch.zeros((bsz, h, n, p), dtype=torch.float32,
                         device=x.device))
    s_in = []
    for zi in range(nc):
        s_in.append(s_run)
        s_run = s_run * chunk_decay[:, zi, :, None, None] + states[:, zi]
    s_in_seq = torch.stack(s_in, dim=1)                       # [B,nc,H,N,P]

    # inter-chunk output: y_off = (c * exp(cum)) @ state_in
    ch = torch.repeat_interleave(cc, rep, dim=3)              # [B,nc,Q,H,N]
    y_off = torch.einsum("bzqhn,bzhnp->bzqhp",
                         ch * torch.exp(cum)[..., None], s_in_seq)

    y = (y_diag + y_off).reshape(bsz, seq, h, p)
    return y.to(x.dtype), s_run


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD update. state [B, H, N, P] fp32; x [B, H, P];
    dt [B, H]; b, c [B, G, N] -> (y [B, H, P] in x's dtype, new state)."""
    rep = x.shape[1] // b.shape[1]
    bh = torch.repeat_interleave(b, rep, dim=1).float()       # [B,H,N]
    ch = torch.repeat_interleave(c, rep, dim=1).float()
    da = torch.exp(dt.float() * a[None, :])                   # [B,H]
    xdt = x.float() * dt.float()[..., None]
    new_state = state * da[..., None, None] + torch.einsum("bhn,bhp->bhnp",
                                                           bh, xdt)
    y = torch.einsum("bhn,bhnp->bhp", ch, new_state)
    return y.to(x.dtype), new_state


# ------------------------------------------------------------ mamba block ---

def _causal_conv(seq_in: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. seq_in [B, S, C]; w [W, C]; w[W-1] multiplies
    the current step. Accumulates in fp32, returns seq_in's dtype."""
    width, seq = w.shape[0], seq_in.shape[1]
    pad = torch.nn.functional.pad(seq_in, (0, 0, width - 1, 0))
    out = torch.zeros(seq_in.shape, dtype=torch.float32,
                      device=seq_in.device)
    for i in range(width):
        out = out + pad[:, i:i + seq].float() * w[i][None, None, :].float()
    return out.to(seq_in.dtype)


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """SiLU-gated RMSNorm of the mixer output, through the kernel wrapper
    (``kernels.fused_layernorm.ops.gated_rmsnorm``), as JAX delegates."""
    return ln_ops.gated_rmsnorm(y, z, scale, eps=eps)


def _split_proj(arch: ArchConfig, zxbcdt: torch.Tensor):
    """in_proj output -> views (z, x, B, C, dt) along the last axis."""
    s = arch.ssm
    inner, h = inner_dim(arch), num_ssm_heads(arch)
    gn = s.ngroups * s.state_dim
    return torch.split(zxbcdt, [inner, inner, gn, gn, h], dim=-1)


def _conv_split(arch: ArchConfig, xbc: torch.Tensor):
    s = arch.ssm
    inner = inner_dim(arch)
    gn = s.ngroups * s.state_dim
    return torch.split(xbc, [inner, gn, gn], dim=-1)


def apply_mamba(arch: ArchConfig, p: Params, u: torch.Tensor,
                par=None) -> torch.Tensor:
    """Full-sequence mamba2 block. u [B, S, D] -> [B, S, D]; on a training
    mesh with a model axis (``par``) the rank's heads (``_rank_mamba``)."""
    with scope("mamba"):
        if par is not None and par.model is not None:
            return _rank_mamba(arch, p, u, par)
        return _apply_mamba(arch, p, u)


def _rank_mamba(arch: ArchConfig, p: Params, u: torch.Tensor, par
                ) -> torch.Tensor:
    """A model rank's heads of the training mixer, JAX's under ("fsdp",
    "tensor") ``in_proj``, (None, "tensor") ``conv`` and ("tensor",
    "fsdp") ``out_proj``: u enters the tensor-parallel region (the whole
    sequence) and meets the rank's ``in_proj`` block (``par.column``: its
    gradient summed from the ranks' fp32 partials), which gives its z, x
    and dt columns (its heads) and 1 / tp of the B and C columns; the causal conv and SiLU run on its channels (depthwise: no
    exchange); B and C are gathered over the model axis in fp32 (their
    gradient reduce-scattered back); the SSD scan runs the rank's heads,
    with the whole ``A_log``, ``D`` and ``dt_bias`` indexed by them; the
    gated norm's row statistic is summed over the model axis
    (``gated_rmsnorm(..., group=)``), with ``norm_scale``'s rank columns;
    ``out_proj``'s rank rows give an fp32 partial sum that leaves the
    region (``par.row``), rounded once after the sum. The whole leaves' gradients are then partial sums
    over the model ranks (the trainer sums them)."""
    from ..parallel import collectives
    s = arch.ssm
    tp, r = par.tp, par.mrank
    h, inner = num_ssm_heads(arch), inner_dim(arch)
    gn = s.ngroups * s.state_dim
    hl, il, gl = h // tp, inner // tp, gn // tp
    zxbcdt = par.column(u, p["in_proj"].to(u.dtype))
    bsz, seq, _ = zxbcdt.shape
    z, xin, b, c, dt = torch.split(zxbcdt, [il, il, gl, gl, hl], dim=-1)
    xbc = silu(_causal_conv(torch.cat([xin, b, c], dim=-1), p["conv"]))
    xin, bc = torch.split(xbc, [il, 2 * gl], dim=-1)
    # gathered in fp32, as the scan reads them: the gradient of B and C,
    # a sum over every head, then reaches the model dtype in one rounding
    # after the reduce-scatter, not one a rank's share of the heads
    every = collectives.gather_seq(bc.float(), par.model, dim=2)
    every = every.reshape(bsz, seq, tp, 2, gl)
    b = every[:, :, :, 0].reshape(bsz, seq, s.ngroups, s.state_dim)
    c = every[:, :, :, 1].reshape(bsz, seq, s.ngroups, s.state_dim)
    # the groups the rank's heads read (each group serves H / G heads)
    per = h // s.ngroups
    g0, g1 = r * hl // per, ((r + 1) * hl - 1) // per + 1
    heads = slice(r * hl, (r + 1) * hl)
    dt = softplus(dt.float() + p["dt_bias"][heads][None, None, :])
    a = -torch.exp(p["A_log"][heads])
    xh = xin.reshape(bsz, seq, hl, s.head_dim)
    y, _ = ssd_chunked(xh, dt, a, b[:, :, g0:g1], c[:, :, g0:g1],
                       min(s.chunk, seq))
    y = y + xh * p["D"][heads][None, None, :, None].to(y.dtype)
    y = ln_ops.gated_rmsnorm(y.reshape(bsz, seq, il), z,
                             p["norm_scale"][r * il:(r + 1) * il],
                             eps=1e-5, group=par.model)
    return par.row(y, p["out_proj"].to(u.dtype))


def _apply_mamba(arch: ArchConfig, p: Params, u: torch.Tensor
                 ) -> torch.Tensor:
    s = arch.ssm
    bsz, seq, _ = u.shape
    h, inner = num_ssm_heads(arch), inner_dim(arch)
    zxbcdt = u @ p["in_proj"].to(u.dtype)
    z, xin, b, c, dt = _split_proj(arch, zxbcdt)
    xbc = silu(_causal_conv(torch.cat([xin, b, c], dim=-1), p["conv"]))
    xin, b, c = _conv_split(arch, xbc)
    dt = softplus(dt.float() + p["dt_bias"][None, None, :])
    a = -torch.exp(p["A_log"])
    xh = xin.reshape(bsz, seq, h, s.head_dim)
    y, _ = ssd_chunked(xh, dt, a, b.reshape(bsz, seq, s.ngroups, s.state_dim),
                       c.reshape(bsz, seq, s.ngroups, s.state_dim),
                       min(s.chunk, seq))
    y = y + xh * p["D"][None, None, :, None].to(y.dtype)
    y = _gated_rmsnorm(y.reshape(bsz, seq, inner), z, p["norm_scale"])
    return y @ p["out_proj"].to(u.dtype)


# ------------------------------------------------------------ decode path ---

def init_mamba_cache(arch: ArchConfig, batch: int, dtype: torch.dtype,
                     device) -> Params:
    """Per-row decode state: the conv tail ``[batch, W-1, C]`` in ``dtype``
    and the SSD state ``[batch, H, N, P]`` in fp32, zeros."""
    s = arch.ssm
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_channels(arch)),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, num_ssm_heads(arch), s.state_dim,
                              s.head_dim), dtype=torch.float32,
                             device=device),
    }


def decode_mamba(arch: ArchConfig, p: Params, u: torch.Tensor, cache: Params
                 ) -> Tuple[torch.Tensor, Params]:
    """One-token mamba2 step. u [B, 1, D] -> (out [B, 1, D], new state);
    ``cache`` is read, not written."""
    s = arch.ssm
    bsz = u.shape[0]
    h = num_ssm_heads(arch)
    zxbcdt = u[:, 0] @ p["in_proj"].to(u.dtype)               # [B, proj]
    z, xin, b, c, dt = _split_proj(arch, zxbcdt)
    xbc = torch.cat([xin, b, c], dim=-1)                      # [B, C]
    window = torch.cat([cache["conv"], xbc[:, None]], dim=1)  # [B, W, C]
    conv_out = torch.sum(window.float() * p["conv"].float()[None], dim=1)
    xin, b, c = _conv_split(arch, silu(conv_out.to(u.dtype)))
    dt = softplus(dt.float() + p["dt_bias"][None, :])
    a = -torch.exp(p["A_log"])
    xh = xin.reshape(bsz, h, s.head_dim)
    y, new_state = ssd_decode_step(
        cache["state"], xh, dt, a, b.reshape(bsz, s.ngroups, s.state_dim),
        c.reshape(bsz, s.ngroups, s.state_dim))
    y = y + xh * p["D"][None, :, None].to(y.dtype)
    y = _gated_rmsnorm(y.reshape(bsz, inner_dim(arch)), z, p["norm_scale"])
    out = (y @ p["out_proj"].to(u.dtype))[:, None]
    return out, {"conv": window[:, 1:], "state": new_state}


def extend_mamba(arch: ArchConfig, p: Params, u: torch.Tensor, cache: Params
                 ) -> Tuple[torch.Tensor, Params]:
    """The static engine's prefill of S tokens u [B, S, D] through a mamba
    block, threading the conv window and the SSD state of ``cache``
    (read, not written) -> (out [B, S, D], new ``{conv, state}``). S == 1
    is a decode step; otherwise S must be a multiple of the SSD chunk (or
    at most one chunk), as in JAX."""
    s = arch.ssm
    bsz, seq, _ = u.shape
    if seq == 1:
        return decode_mamba(arch, p, u, cache)
    h, inner, width = num_ssm_heads(arch), inner_dim(arch), s.conv_width
    zxbcdt = u @ p["in_proj"].to(u.dtype)
    z, xin, b, c, dt = _split_proj(arch, zxbcdt)
    xbc = torch.cat([xin, b, c], dim=-1)                      # [B, S, C]
    ctx = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)  # [B,W-1+S,C]
    conv_out = torch.zeros(xbc.shape, dtype=torch.float32, device=u.device)
    for i in range(width):
        conv_out = conv_out + ctx[:, i:i + seq].float() \
            * p["conv"][i][None, None].float()
    new_conv = ctx[:, seq:]                                   # last W-1 rows
    xin, b, c = _conv_split(arch, silu(conv_out.to(u.dtype)))
    dt = softplus(dt.float() + p["dt_bias"][None, None, :])
    a = -torch.exp(p["A_log"])
    xh = xin.reshape(bsz, seq, h, s.head_dim)
    chunk = min(s.chunk, seq)
    if seq % chunk:
        raise ValueError(f"prefill length {seq} not a multiple of chunk "
                         f"{chunk}")
    y, final = ssd_chunked(xh, dt, a,
                           b.reshape(bsz, seq, s.ngroups, s.state_dim),
                           c.reshape(bsz, seq, s.ngroups, s.state_dim),
                           chunk, initial_state=cache["state"])
    y = y + xh * p["D"][None, None, :, None].to(y.dtype)
    y = _gated_rmsnorm(y.reshape(bsz, seq, inner), z, p["norm_scale"])
    return y @ p["out_proj"].to(u.dtype), {"conv": new_conv, "state": final}


# ------------------------------------------- serving decode-state path -----
#
# The continuous engine's per-layer decode-state protocol: a mamba mixer's
# state is not page-decomposable (the recurrence folds every past token into
# one [H, N, P] state), so it is a pooled, constant-size per-slot state,
# ``init_mamba_cache(arch, num_slots, ...)``: conv tail [slot, W-1, C] and
# SSD state [slot, H, N, P] fp32. A slot is recycled by resetting its row
# (``start == 0`` below), and preemption is forced replay: re-prefilling the
# victim's context recomputes the state.

def paged_prefill_mamba_layer(arch: ArchConfig, p: Params, x: torch.Tensor,
                              cache: Params, slot: int, start: int,
                              total_len: int) -> torch.Tensor:
    """One prompt chunk of one sequence through a mamba mixer; the slot's
    rows of ``cache`` are updated in place.

    x [1, C, D]: row i at absolute position start + i; rows at or past
    ``total_len - start`` are padding. A padded position's ``dt`` is forced
    to 0, so its decay exp(dt * a) is 1 and its input x * dt is 0: the
    chunk's final state is the state after the last valid token.
    ``start == 0`` (a fresh admission or a forced-replay re-prefill) starts
    from zeros instead of the slot's rows.
    """
    s = arch.ssm
    bsz, c, _ = x.shape
    assert bsz == 1, "chunked prefill runs one sequence at a time"
    h, inner, width = num_ssm_heads(arch), inner_dim(arch), s.conv_width
    zxbcdt = x[0] @ p["in_proj"].to(x.dtype)                  # [C, proj]
    z, xin, bb, cc, dt = _split_proj(arch, zxbcdt)
    xbc = torch.cat([xin, bb, cc], dim=-1)                    # [C, Cch]
    if start > 0:
        conv_tail = cache["conv"][slot].to(xbc.dtype)
        state0 = cache["state"][slot]
    else:
        conv_tail = torch.zeros((width - 1, xbc.shape[-1]), dtype=xbc.dtype,
                                device=x.device)
        state0 = torch.zeros(cache["state"].shape[1:], dtype=torch.float32,
                             device=x.device)
    ctx = torch.cat([conv_tail, xbc], dim=0)                  # [W-1+C, Cch]
    conv_out = torch.zeros(xbc.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        conv_out = conv_out + ctx[i:i + c].float() * p["conv"][i][None].float()
    xin, bb, cc = _conv_split(arch, silu(conv_out.to(x.dtype)))
    valid = torch.arange(c, device=x.device) < total_len - start
    dt = softplus(dt.float() + p["dt_bias"][None, :])
    dt = torch.where(valid[:, None], dt, torch.zeros((), device=x.device))
    a = -torch.exp(p["A_log"])
    xh = xin.reshape(1, c, h, s.head_dim)
    # the chunk length is fixed; gcd keeps the SSD divisibility contract
    # for any page-multiple prefill chunk
    y, final = ssd_chunked(xh, dt[None], a,
                           bb.reshape(1, c, s.ngroups, s.state_dim),
                           cc.reshape(1, c, s.ngroups, s.state_dim),
                           math.gcd(s.chunk, c), initial_state=state0[None])
    y = y + xh * p["D"][None, None, :, None].to(y.dtype)
    y = _gated_rmsnorm(y.reshape(1, c, inner), z[None], p["norm_scale"])
    # conv tail = the W-1 inputs ending at the last valid token: ctx row
    # j >= W-1 is chunk position j - (W-1) (a start past the chunk is
    # clamped to its end, as JAX's dynamic_slice clamps)
    n = min(total_len - start, c)
    cache["conv"][slot] = ctx[n:n + width - 1].to(cache["conv"].dtype)
    cache["state"][slot] = final[0]
    return y @ p["out_proj"].to(x.dtype)


def paged_decode_mamba_layer(arch: ArchConfig, p: Params, x: torch.Tensor,
                             cache: Params, active: torch.Tensor
                             ) -> torch.Tensor:
    """One-token decode over the full slot batch. x [S, 1, D]; ``active``
    [S] bool. The rows of active slots are updated in place; an inactive
    slot (empty, or mid-prefill and masked out of this step) keeps its
    state: there is no null-page sink for state, the row itself would be
    the sink, so the update is a select on ``active``."""
    y, new = decode_mamba(arch, p, x, cache)
    cache["conv"].copy_(torch.where(active[:, None, None], new["conv"],
                                    cache["conv"]))
    cache["state"].copy_(torch.where(active[:, None, None, None],
                                     new["state"], cache["state"]))
    return y
