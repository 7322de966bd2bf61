"""Architecture and run configs: the fields of
``repro.configs.base.{MoEConfig, SSMConfig, ArchConfig, ShapeConfig,
RunConfig}`` that the serving paths (continuous: the dense, moe, vlm, ssm
and hybrid families; static: those and encdec), the training path and the
analytical model (``param_count``) read, as the port's own frozen
dataclasses (values copied, nothing imported)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string -> ``torch.dtype``."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(DTYPES)}") \
            from None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Token-choice MoE sub-config."""

    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    expert_ff: int = 0              # per-expert intermediate (0 -> d_ff)
    capacity_factor: float = 1.25
    every: int = 1                  # one MoE layer every `every` layers
    first: int = 0                  # index of the first MoE layer
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD, arXiv:2405.21060) sub-config."""

    state_dim: int = 128            # N: SSM state size per head
    head_dim: int = 64              # P: channels per SSD head
    expand: int = 2                 # inner dim = expand * d_model
    chunk: int = 256                # SSD chunk length
    conv_width: int = 4             # depthwise causal conv width
    ngroups: int = 1                # B/C groups


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec |
                                    # vlm (the port serves all six: encdec
                                    # on the static engine only; it trains
                                    # dense)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    mlp: str = "swiglu"
    norm: str = "rmsnorm"
    pos_emb: str = "rope"           # rope | mrope | learned | sinusoidal
                                    # | none
    rope_theta: float = 10_000.0
    use_bias: bool = False
    tie_embeddings: bool = False
    dtype: str = "bfloat16"         # compute / activation dtype (serving
                                    # weights too)
    param_dtype: str = "float32"    # training's master parameter dtype
    attn_impl: str = "chunked"      # naive | chunked | flash: the
                                    # attention above attn_chunk
    attn_chunk: int = 1024          # KV length above which attention is
                                    # chunked (or flash); its KV block
    window: int = 0                 # sliding-window attention (0 = full)
    post_norm: bool = False         # BERT-style post-LN blocks
    bidirectional: bool = False     # encoder-only attention (BERT)
    mlm_transform: bool = False     # BERT MLM head (dense + gelu + LN)
    max_position: int = 512         # learned-position table size
    remat: bool = True              # recompute each block in backward
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: period and which index within the period is attention
    hybrid_period: int = 0
    hybrid_attn_index: int = 0
    # encoder (encdec only)
    enc_layers: int = 0
    enc_seq_len: int = 0            # encoder frames per example (1500)
    # frontends are stubs: inputs arrive as precomputed embeddings
    frontend: str = "none"          # none | audio_stub | vision_stub

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    def is_attention_layer(self, layer_idx: int) -> bool:
        """For hybrid stacks: does layer ``layer_idx`` use attention?"""
        if self.family in ("dense", "moe", "encdec", "vlm"):
            return True
        if self.family == "ssm":
            return False
        assert self.hybrid_period > 0
        return layer_idx % self.hybrid_period == self.hybrid_attn_index

    def is_moe_layer(self, layer_idx: int) -> bool:
        """Does layer ``layer_idx`` hold a MoE in place of its MLP?"""
        if self.moe is None:
            return False
        m = self.moe
        return layer_idx >= m.first and (layer_idx - m.first) % m.every == 0

    def param_count(self, active_only: bool = False) -> int:
        """Closed-form parameter count (embedding included once), as
        ``repro.configs.base.ArchConfig.param_count``; ``active_only``
        counts a MoE layer's top-k routed experts instead of all of them;
        an encdec arch adds its encoder layers and each decoder layer's
        cross-attention with its norm."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d                                     # embedding
        if not self.tie_embeddings:
            total += v * d                                # lm head
        bias = 1 if self.use_bias else 0

        def attn_params() -> int:
            qp = d * self.q_dim + bias * self.q_dim
            kp = d * self.kv_dim + bias * self.kv_dim
            vp = d * self.kv_dim + bias * self.kv_dim
            op = self.q_dim * d + bias * d
            return qp + kp + vp + op

        def mlp_params(inner: int) -> int:
            if self.mlp == "swiglu":
                return 3 * d * inner + bias * (2 * inner + d)
            return 2 * d * inner + bias * (inner + d)

        def moe_params(active: bool) -> int:
            m = self.moe
            eff = m.expert_ff or ff
            router = d * m.num_experts
            shared = m.num_shared_experts * mlp_params(eff)
            routed = (m.top_k if active else m.num_experts) * mlp_params(eff)
            return router + shared + routed

        def ssm_params() -> int:
            s = self.ssm
            inner = s.expand * d
            nheads = inner // s.head_dim
            in_proj = d * (2 * inner + 2 * s.ngroups * s.state_dim + nheads)
            conv = s.conv_width * (inner + 2 * s.ngroups * s.state_dim)
            out_proj = inner * d
            extra = 3 * nheads + inner      # A, D, dt_bias, gate norm
            return in_proj + conv + out_proj + extra

        for layer in range(self.num_layers):
            total += 2 * d                  # two norms per block
            if self.is_attention_layer(layer):
                total += attn_params()
            else:
                total += ssm_params()
            if self.is_moe_layer(layer):
                total += moe_params(active_only)
            elif self.family != "ssm":      # mamba2 blocks have no MLP
                total += mlp_params(ff)
        if self.family == "encdec":
            for _ in range(self.enc_layers):
                total += attn_params() + mlp_params(ff) + 2 * d
            total += self.num_layers * (attn_params() + d)
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input shape: ``microbatches`` splits a train batch for gradient
    accumulation (paper section 4.2)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode
    microbatches: int = 1


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """What ``build_train_step`` needs besides the architecture."""
    arch: ArchConfig
    shape: ShapeConfig
    optimizer: str = "lamb"         # lamb | adamw | sgd
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    zero1: bool = True              # the ZeRO-1 flat optimizer layout
    fused_optimizer_kernel: bool = False   # route LAMB through the kernels
    # bf16 model params + fp32 master copies in the optimizer (paper
    # section 3.2.1); False = everything fp32
    master_weights: bool = True
    grad_clip: float = 1.0

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
