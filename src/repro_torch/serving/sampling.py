"""Per-request stochastic decoding: ``SamplingParams`` and the sampler the
engine's decode step and final prefill chunk share. Counterpart of
``repro.serving.sampling``, with the same determinism contract: the draw for
the token at stream position p of a request with seed s uses the uniform of
``fold_in(key(s), p)`` and nothing else, so streams do not depend on the
slot, the batch neighbours or preemption replay, and match the JAX engine's
draw for draw.

Order: temperature scaling, then top-k, then top-p, then one inverse-CDF
draw. ``temperature == 0`` rows take the raw argmax.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from ..kernels.fused_sampling import ops as fused_ops
from ..kernels.fused_sampling import ref as fused_ref


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How one request's tokens are chosen.

    temperature  0 = greedy argmax; > 0 divides the logits before the draw.
    top_k        keep only the k highest logits (0 = disabled).
    top_p        nucleus mass in (0, 1] (1.0 = disabled).
    seed         per-request seed; position p draws from fold_in(key(seed), p).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0: {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables): {self.top_k}")
        if not 0 < self.top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1]: {self.top_p}")
        if not 0 <= self.seed < 2 ** 32:
            raise ValueError(f"seed must fit in uint32: {self.seed}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    @property
    def filtered(self) -> bool:
        """True when top-k or top-p actually constrains the distribution."""
        return self.top_k > 0 or self.top_p < 1.0


def sample_tokens(logits: torch.Tensor, seeds: torch.Tensor,
                  positions: torch.Tensor, temperatures: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor, *,
                  filtered: bool = True, fused: bool = True) -> torch.Tensor:
    """One token per row of ``logits`` [B, V] -> int32 [B]. Per-row inputs:
    ``seeds`` (uint32 values), ``positions`` (stream position of the emitted
    token), ``temperatures`` / ``top_p`` float32, ``top_k`` int32.
    ``filtered=False`` skips the top-k/top-p epilogue (exact when every row
    has both disabled); ``fused`` picks the filter: the kernel wrapper
    (plain bisection on the CPU) or the sort-based oracle. The draw goes
    through the draw kernel's wrapper, which derives each row's uniform
    from its seed and position on the card (its plain version on the
    CPU)."""
    greedy = torch.argmax(logits, dim=-1).int()
    temps = temperatures.float()
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    lg = logits.float() / safe_t[:, None]
    if filtered:
        fn = fused_ops.filter_logits if fused else fused_ref.filter_logits_ref
        lg = fn(lg.contiguous(), top_k.int(), top_p.float())
    drawn = fused_ops.draw_tokens(lg.contiguous(), seeds, positions)
    return torch.where(temps > 0, drawn, greedy)


def fused_sampling_enabled() -> bool:
    """Environment default of the engines' ``fused_sampling`` flag (the
    top-k / top-p filter kernel against the sort-based oracle): on unless
    ``REPRO_FUSED_SAMPLING`` is set to ``0`` or the empty string (the JAX
    package's rule). The two filters give the same tokens, so the flag
    changes step latency only."""
    return os.environ.get("REPRO_FUSED_SAMPLING", "1") not in ("", "0")


def fused_decode_enabled() -> bool:
    """Environment default of the engine's ``fused_decode`` flag: on unless
    ``REPRO_FUSED_DECODE`` is set to ``0`` or the empty string (the JAX
    package's rule). Both paths emit the same tokens on the CPU, so the
    flag changes memory traffic and launches."""
    return os.environ.get("REPRO_FUSED_DECODE", "1") not in ("", "0")
