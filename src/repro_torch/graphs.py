"""Captured CUDA graphs whose kernel launches stay counted.

The port's counterparts of a jitted JAX function: a piece of work whose
buffers keep their addresses is captured once as a ``torch.cuda.CUDAGraph``
and then replayed, with no Python-issued launch in between. Two users: the
multi-step decode loop (``serving.graphs.DecodeLoop``) and the training
step (``train.steps.StepGraph``).

Python's cyclic garbage collector is run before a capture and held off
during it: a collection in the middle of one could free an unreachable
object holding another graph, pinned host memory or an event, and a CUDA
call that frees one invalidates the capture.

The kernel wrappers count a launch in Python, which runs at capture and not
at replay: a capture's counts are taken back (``counted``), and each replay
adds the launches captured (``replay``), so every ``LAUNCHES`` dict stays
exact.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Callable, Dict, List, Tuple

import torch


def launch_counters() -> List[Dict[str, int]]:
    """Every kernel wrapper's ``LAUNCHES`` dict."""
    from .kernels.bias_gelu import ops as gelu_ops
    from .kernels.decode_attention import ops as attn_ops
    from .kernels.flash_attention import ops as flash_ops
    from .kernels.fused_lamb import ops as lamb_ops
    from .kernels.fused_layernorm import ops as ln_ops
    from .kernels.fused_lm_head import ops as head_ops
    from .kernels.fused_sampling import ops as samp_ops
    from .kernels.fused_softmax import ops as softmax_ops
    return [m.LAUNCHES for m in (attn_ops, flash_ops, ln_ops, head_ops,
                                 samp_ops, gelu_ops, lamb_ops, softmax_ops)]


@dataclasses.dataclass
class Captured:
    """A captured graph (anything with ``replay()``), the launches one
    replay makes (kernel name -> count) and the addresses it was captured
    against."""
    graph: object
    launches: Dict[str, int]
    pools: Tuple[int, ...] = ()


def counted(record: Callable[[], None]) -> Dict[str, int]:
    """Run ``record`` (a capture) and return the launches the wrappers
    counted in it, taking them back from every ``LAUNCHES`` dict: a
    capture launches nothing."""
    before = [dict(d) for d in launch_counters()]
    record()
    launches: Dict[str, int] = {}
    for d, was in zip(launch_counters(), before):
        for name, n in d.items():
            if n != was[name]:
                launches[name] = n - was[name]
            d[name] = was[name]
    return launches


def replay(entry: Captured, k: int = 1) -> None:
    """``k`` replays of a captured graph, each counted as the launches it
    captured."""
    for _ in range(k):
        entry.graph.replay()
    if k:
        for d in launch_counters():
            for name in d:
                d[name] += k * entry.launches.get(name, 0)


def warm_up(step: Callable[[], None], stream) -> None:
    """Run ``step`` eagerly on the side ``stream`` that will capture it,
    ordered after and before the current stream's work: library builds,
    ``ctypes`` bindings, first-use ``cudaFuncSetAttribute`` calls and the
    stream's cuBLAS workspace all happen here, outside any capture."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        step()
    current.wait_stream(stream)


def capture(step: Callable[[], None], *, pool, stream, device,
            pools: Tuple[int, ...] = ()) -> Tuple[Captured, int]:
    """Capture ``step`` on ``stream`` into the memory pool ``pool`` (a
    ``torch.cuda.graph_pool_handle()``), its launches taken back. Returns
    the captured graph and the bytes the capture added to the device's
    reserved memory (the graph's share of the pool)."""
    torch.cuda.synchronize(device)
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()

    def record():
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                step()
        finally:
            if collecting:
                gc.enable()
    launches = counted(record)
    return (Captured(graph, launches, pools),
            torch.cuda.memory_reserved(device) - reserved)
