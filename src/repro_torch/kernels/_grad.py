"""Gradients of the kernels that have no backward kernel.

The JAX package's training kernels (``fused_residual_layernorm``,
``bias_gelu``) run forward only: JAX differentiates their plain reference.
``PlainBackward`` does the same in the port: its forward launches the
kernel, and its backward recomputes the kernel's plain version under
autograd and returns that version's gradients. The gradient is then exactly
the one that autodiff of the plain version gives.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


class PlainBackward(torch.autograd.Function):
    """``PlainBackward.apply(kernel, plain, *args)``: ``kernel(*args)``
    forward, the gradients of ``plain(*args)`` backward. ``args`` are
    tensors or None (an absent bias); keywords are bound into the two
    callables beforehand."""

    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable,
                *args: Optional[torch.Tensor]) -> torch.Tensor:
        ctx.plain = plain
        ctx.save_for_backward(*args)
        return kernel(*args)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            args = [a.detach().requires_grad_(n) if a is not None else None
                    for a, n in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*args)
            wrt = [a for a, n in zip(args, needs) if n and a is not None]
            grads = iter(torch.autograd.grad(out, wrt, grad_out)
                         if wrt else ())
        return (None, None) + tuple(
            next(grads) if n and a is not None else None
            for a, n in zip(args, needs))
