"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper.

The package mirrors ``repro``'s module names so each part has an obvious
counterpart, but imports nothing from it (nor ``jax``): every piece it needs
is its own copy. What it carries today:

- the continuous engine serving the dense family and the attention-free
  ssm family (mamba2) through the per-layer decode-state protocol (chunked
  paged prefill, paged decode, per-slot mamba state, per-request sampling,
  fused decode on by default);
- the static engine (``launch.serve --engine static``, the default, or
  ``launch.serve.run_static``): a dense cache, the whole prompt prefilled
  at once (``Model.prefill``; above ``attn_chunk`` the chunked attention,
  or the flash kernel for a config with ``attn_impl="flash"``), then
  lock-step decode (``Model.decode_step``), dense and mamba2;
- training on one device (``launch.train``): every arch of the registry,
  MLM where the arch is bidirectional, else causal, each step after the
  second one replay of a captured CUDA graph on the card, with
  checkpoint/restart in JAX's file format (``checkpoint``); and, with
  ZeRO-1 (``optim.zero``, JAX's default layout), on the data axis of a
  mesh of ranks (``build_train_step(run, mesh=launch.mesh.make_mesh(...))``),
  beside JAX's compressed and hierarchical collectives and its GPipe
  pipeline (``parallel``);
- the paper's analytical model and its operator-level characterization
  (``core``): ``core.characterize.analyze(fn, *args)`` runs ``fn`` once
  and prices every op it ran, bucketed by the paper's taxonomy and by
  JAX's named scopes (on the CPU, e.g. a ``build_train_step(run,
  device="cpu")`` bundle's ``eager`` step; ``chip_smoke.py`` prints the
  fused bert-large step's on the card);

with twelve hand-written sm_90a kernels:

- ``kernels.decode_attention``: paged decode and paged prefill attention
- ``kernels.flash_attention``: the flash attention forward
- ``kernels.fused_sampling``: the top-k / top-p logit filter and the draw
- ``kernels.fused_layernorm``: the decode residual stream's add + norm,
  the training block's post-norm add + norm, and the mamba mixer's
  SiLU-gated RMSNorm
- ``kernels.fused_lm_head``: the LM head with token selection
- ``kernels.bias_gelu``: the GeLU MLP's bias + activation
- ``kernels.fused_lamb``: LAMB's two stages, one parameter leaf a call
  (one trust ratio a layer, a MoE expert leaf one an expert), or a
  data-parallel rank's columns of the ZeRO flat leaves

Entry points take a ``device`` argument that defaults to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default) demands a
    card; the CPU is used only when the caller asks for it explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
