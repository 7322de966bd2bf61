"""Gradients of the kernels that have no backward kernel.

The JAX package's kernels run forward only: JAX differentiates their plain
reference. ``PlainBackward`` does the same in the port: its forward
launches the kernel, and its backward recomputes the kernel's plain version
under autograd and returns that version's gradients. The gradient is then
exactly the one that autodiff of the plain version gives. A kernel may
return one tensor or a tuple of them (``decode_residual_norm``'s ``(h,
x_new)``); the plain version returns the same.
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
                *args: Optional[torch.Tensor]):
        ctx.plain = plain
        ctx.save_for_backward(*args)
        return kernel(*args)

    @staticmethod
    def backward(ctx, *grad_outs: torch.Tensor):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            args = [a.detach().requires_grad_(n) if a is not None else None
                    for a, n in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*args)
            outs = out if isinstance(out, tuple) else (out,)
            wrt = [a for a, n in zip(args, needs) if n and a is not None]
            grads = iter(torch.autograd.grad(outs, wrt, grad_outs)
                         if wrt else ())
        return (None, None) + tuple(
            next(grads) if n and a is not None else None
            for a, n in zip(args, needs))


def wants_grad(*args: Optional[torch.Tensor]) -> bool:
    """Whether autograd would record a call on ``args``: grad mode is on
    and a tensor among them requires a gradient."""
    return torch.is_grad_enabled() and any(
        a is not None and a.requires_grad for a in args)


def refuse_grad(what: str, *args: Optional[torch.Tensor]) -> None:
    """Raise where a kernel with no backward would be recorded: its output
    would carry no gradient."""
    if wants_grad(*args):
        raise NotImplementedError(f"{what} has no backward in repro_torch")
