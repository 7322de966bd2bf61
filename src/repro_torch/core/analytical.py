"""Closed-form operator inventory: the paper's Table 3, generalized, ported
from ``repro.core.analytical``.

For an ArchConfig x (batch, seq) this enumerates every GEMM with its
(M, N, K, batch) for FWD / BWD-grad-activation / BWD-grad-weight (the
paper's three columns), plus the non-GEMM phases (LAMB stages, the
attention's scale, mask and softmax, GeLU/SwiGLU, dropout + residual +
norm) with their FLOPs, bytes and arithmetic intensity (Fig. 7/8). The
attention phase is what ``kernels/fused_softmax`` fuses into one kernel;
the inventory counts it as the paper profiled it, four kernels a layer.

Every family of the port's config is covered (dense, moe, vlm, ssm,
hybrid, the MoE rows at padded capacity tokens, as the dispatch computes
them; encdec counts its encoder's self-attention and MLP and each decoder
layer's cross-attention as further attention layers, as JAX's does).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from ..configs.base import ArchConfig
from ..models import ssm as ssm_lib
from ..models.layers import pad_vocab
from .roofline import H100, DeviceSpec


@dataclasses.dataclass
class Gemm:
    name: str
    layer: str                  # attn_linear | attn_bgemm | fc | moe | ssm
                                # | head
    m: int
    n: int
    k: int
    batch: int = 1
    count: int = 1              # per model per pass

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.n * self.k * self.batch * self.count

    def bytes_(self, dtype_bytes: int = 2) -> float:
        per = (self.m * self.k + self.k * self.n + self.m * self.n)
        return per * self.batch * self.count * dtype_bytes

    def intensity(self, dtype_bytes: int = 2) -> float:
        return self.flops / max(self.bytes_(dtype_bytes), 1.0)


@dataclasses.dataclass
class EwOp:
    name: str
    layer: str                  # lamb | attn_softmax | activation | drn | loss
    flops: float
    bytes: float
    count: int = 1

    @property
    def total_flops(self) -> float:
        return self.flops * self.count

    @property
    def total_bytes(self) -> float:
        return self.bytes * self.count

    @property
    def intensity(self) -> float:
        return self.total_flops / max(self.total_bytes, 1.0)


def transformer_gemms(arch: ArchConfig, batch: int, seq: int,
                      phase: str = "fwd") -> List[Gemm]:
    """The paper's Table 3 rows for one pass over the whole model.

    phase: fwd | bwd_act | bwd_w (BWD rows transpose dims as Table 3).
    """
    t = batch * seq                       # n*B, the token count
    d = arch.d_model
    hd = arch.resolved_head_dim
    out: List[Gemm] = []
    n_attn = sum(1 for i in range(arch.num_layers)
                 if arch.is_attention_layer(i))
    n_moe = sum(1 for i in range(arch.num_layers) if arch.is_moe_layer(i))
    n_dense_mlp = 0 if arch.family == "ssm" else arch.num_layers - n_moe
    if arch.family == "encdec":
        n_attn += arch.enc_layers + arch.num_layers     # enc self + dec cross
        n_dense_mlp += arch.enc_layers

    def gemm(name, layer, m, n, k, b=1, count=1):
        if phase == "fwd":
            out.append(Gemm(name, layer, m, n, k, b, count))
        elif phase == "bwd_act":
            out.append(Gemm(name, layer, k, n, m, b, count))
        else:                           # bwd_w
            out.append(Gemm(name, layer, m, k, n, b, count))

    if arch.num_heads:
        # linear transforms (q, k, v fused + output projection)
        gemm("qkv_proj", "attn_linear", arch.q_dim + 2 * arch.kv_dim, t, d,
             count=n_attn)
        gemm("attn_out", "attn_linear", d, t, arch.q_dim, count=n_attn)
        # attention batched GEMMs (per the paper: B*h small GEMMs)
        gemm("attn_score", "attn_bgemm", seq, seq, hd,
             b=batch * arch.num_heads, count=n_attn)
        gemm("attn_pv", "attn_bgemm", hd, seq, seq,
             b=batch * arch.num_heads, count=n_attn)
    if n_dense_mlp:
        gemm("fc1", "fc", arch.d_ff, t, d,
             count=n_dense_mlp * (2 if arch.mlp == "swiglu" else 1))
        gemm("fc2", "fc", d, t, arch.d_ff, count=n_dense_mlp)
    if n_moe:
        moe = arch.moe
        eff = moe.expert_ff or arch.d_ff
        cap_tokens = int(t * moe.top_k * moe.capacity_factor)
        gemm("moe_up", "moe", eff, cap_tokens, d,
             count=n_moe * (2 if arch.mlp == "swiglu" else 1))
        gemm("moe_down", "moe", d, cap_tokens, eff, count=n_moe)
        gemm("router", "moe", moe.num_experts, t, d, count=n_moe)
        if moe.num_shared_experts:
            sf = eff * moe.num_shared_experts
            gemm("moe_shared_up", "moe", sf, t, d, count=n_moe * 2)
            gemm("moe_shared_down", "moe", d, t, sf, count=n_moe)
    if arch.ssm is not None:
        inner = ssm_lib.inner_dim(arch)
        h = ssm_lib.num_ssm_heads(arch)
        s_ = arch.ssm
        n_mamba = (arch.num_layers
                   - (n_attn if arch.family == "hybrid" else 0)) \
            if arch.family in ("ssm", "hybrid") else 0
        if n_mamba:
            proj = 2 * inner + 2 * s_.ngroups * s_.state_dim + h
            gemm("ssm_in_proj", "ssm", proj, t, d, count=n_mamba)
            gemm("ssm_out_proj", "ssm", d, t, inner, count=n_mamba)
            q = min(s_.chunk, seq)
            nc = max(seq // q, 1)
            # SSD chunk GEMMs: the 'skinny' ones (paper Takeaway 7 analogue)
            gemm("ssd_scores", "ssm", q, q, s_.state_dim,
                 b=batch * nc * s_.ngroups, count=n_mamba)
            gemm("ssd_diag", "ssm", q, s_.head_dim, q,
                 b=batch * nc * h, count=n_mamba)
            gemm("ssd_state", "ssm", s_.state_dim, s_.head_dim, q,
                 b=batch * nc * h, count=n_mamba)
            gemm("ssd_off", "ssm", q, s_.head_dim, s_.state_dim,
                 b=batch * nc * h, count=n_mamba)
    # output head
    gemm("lm_head", "head", pad_vocab(arch.vocab_size), t, d)
    return out


def nongemm_ops(arch: ArchConfig, batch: int, seq: int,
                dtype_bytes: int = 2) -> List[EwOp]:
    """Paper section 3.2.3: the memory-bound phases with their flops and
    bytes."""
    t = batch * seq
    d = arch.d_model
    params = arch.param_count()
    nl = arch.num_layers
    acts = t * d * dtype_bytes
    n_attn = sum(1 for i in range(nl) if arch.is_attention_layer(i))
    # flops/bytes are PER KERNEL INSTANCE; count = kernel launches per step
    ops = [
        # LAMB stage 1 (fused per layer, as in PyTorch): read w,g,m,v + write
        # m,v,u in fp32, the paper's "4x model size" traffic (Takeaway 8)
        EwOp("lamb_stage1", "lamb", flops=10 * params / nl,
             bytes=7 * 4 * params / nl, count=nl),
        # 2-norms + stage 2: read w,u + write w
        EwOp("lamb_stage2", "lamb", flops=3 * params / nl,
             bytes=3 * 4 * params / nl, count=nl),
    ]
    if arch.num_heads:
        # paper: scale, mask, softmax, dropout are 4 separate kernels per layer
        scores = batch * arch.num_heads * seq * seq
        ops.append(EwOp("attn_scale_mask_softmax", "attn_softmax",
                        flops=2 * scores, bytes=2 * scores * 4,
                        count=4 * n_attn))
    act_elems = t * (arch.d_ff or d)
    ops.append(EwOp("gelu" if arch.mlp == "gelu" else "swiglu_silu",
                    "activation", flops=8 * act_elems,
                    bytes=2 * act_elems * dtype_bytes, count=nl))
    ops.append(EwOp("dropout_residual_norm", "drn",
                    flops=t * d, bytes=2 * acts, count=6 * nl))
    ops.append(EwOp("loss_softmax", "loss",
                    flops=2 * t * arch.vocab_size,
                    bytes=2 * t * arch.vocab_size * 4, count=4))
    return ops


# ------------------------------------------------------ runtime estimation ---

def phase_times(arch: ArchConfig, batch: int, seq: int,
                dev: DeviceSpec = H100, dtype_bytes: int = 2,
                train: bool = True) -> Dict[str, float]:
    """Roofline runtime per paper bucket (Fig 4/5 reproduction), single
    device.

    GEMM passes: fwd + bwd_act + bwd_w for training; EW ops scale 3x for
    fwd+bwd except LAMB (once per step) and loss.
    """
    times: Dict[str, float] = {}

    def add(bucket: str, secs: float):
        times[bucket] = times.get(bucket, 0.0) + secs

    phases = ("fwd", "bwd_act", "bwd_w") if train else ("fwd",)
    for phase in phases:
        for gm in transformer_gemms(arch, batch, seq, phase):
            t_c = gm.flops / dev.peak_flops
            t_m = gm.bytes_(dtype_bytes) / dev.hbm_bw
            add(gm.layer, max(t_c, t_m))
    for ew in nongemm_ops(arch, batch, seq, dtype_bytes):
        mult = 1
        if train and ew.layer in ("attn_softmax", "activation", "drn"):
            mult = 3                          # fwd + larger bwd (paper 3.2.3)
        if not train and ew.layer == "lamb":
            continue
        t_c = ew.total_flops / dev.peak_flops
        t_m = ew.total_bytes / (dev.hbm_bw * dev.ew_bw_efficiency)
        t_launch = ew.count * dev.kernel_overhead
        add(ew.layer, (max(t_c, t_m) + t_launch) * mult)
    return times


def total_flops(arch: ArchConfig, batch: int, seq: int,
                train: bool = True) -> float:
    phases = ("fwd", "bwd_act", "bwd_w") if train else ("fwd",)
    return sum(gm.flops for phase in phases
               for gm in transformer_gemms(arch, batch, seq, phase))
