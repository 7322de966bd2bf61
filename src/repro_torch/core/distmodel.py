"""Analytical multi-device training profiles, the paper's section 4.1.1
method, ported from ``repro.core.distmodel``.

The paper builds per-device distributed profiles from single-device
measurements plus a ring-AllReduce communication model; this does the same
from the analytical inventory, for Fig. 12's five configurations:

  S1  single device, B=16
  D1  data parallel, B=16/device, gradient all-reduce overlapped per layer
  D2  data parallel, no overlap (all gradients communicated after backprop)
  M1  2-way Megatron intra-layer model parallel
  M2  8-way model parallel, B scaled to 64

Communication: ring all-reduce moves 2(g-1)/g * bytes per device at the
device's ``ici_bw``. The default device is the paper's, ``MI100_FP32``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..configs.base import ArchConfig
from .analytical import phase_times
from .roofline import MI100_FP32, DeviceSpec


def ring_allreduce_time(bytes_per_device: float, group: int,
                        link_bw: float) -> float:
    if group <= 1:
        return 0.0
    return 2.0 * (group - 1) / group * bytes_per_device / link_bw


@dataclasses.dataclass
class DistProfile:
    name: str
    phase_times: Dict[str, float]
    comm_time: float
    comm_bytes: float

    @property
    def total(self) -> float:
        return sum(self.phase_times.values()) + self.comm_time

    def breakdown(self) -> Dict[str, float]:
        out = dict(self.phase_times)
        out["communication"] = self.comm_time
        return out


def data_parallel(arch: ArchConfig, batch: int, seq: int, devices: int,
                  overlap: bool, dev: DeviceSpec = MI100_FP32,
                  dtype_bytes: int = 4) -> DistProfile:
    """Paper D1/D2: model replicated; per-device compute == single device;
    gradient ring all-reduce, optionally overlapped layer by layer with the
    backward pass."""
    times = phase_times(arch, batch, seq, dev, dtype_bytes)
    grad_bytes = arch.param_count() * dtype_bytes
    t_comm = ring_allreduce_time(grad_bytes, devices, dev.ici_bw)
    if overlap:
        # per-layer comms overlap with the next layer's bwd compute (paper:
        # max(comp, comm) pairwise): only the first layer's reduce is exposed
        bwd_compute = sum(v for k, v in times.items() if k != "lamb") * (2 / 3)
        exposed = max(t_comm - bwd_compute, t_comm / arch.num_layers)
        t_comm = exposed
    return DistProfile(
        name=f"DP{'+ov' if overlap else ''} x{devices}",
        phase_times=times, comm_time=t_comm, comm_bytes=grad_bytes)


def model_parallel(arch: ArchConfig, batch: int, seq: int, mp: int,
                   dev: DeviceSpec = MI100_FP32,
                   dtype_bytes: int = 4) -> DistProfile:
    """Paper M1/M2 (Megatron intra-layer): per-device GEMM dims /mp; LAMB
    /mp; 4 serialized activation all-reduces per transformer layer (2 fwd +
    2 bwd)."""
    shrunk = dataclasses.replace(
        arch,
        d_ff=arch.d_ff // mp,
        num_heads=max(arch.num_heads // mp, 1) if arch.num_heads else 0,
        num_kv_heads=(max(arch.num_kv_heads // mp, 1) if arch.num_kv_heads
                      else 0),
        head_dim=arch.resolved_head_dim)
    times = phase_times(shrunk, batch, seq, dev, dtype_bytes)
    # LAMB scales with the local parameter count
    for k in list(times):
        if k == "lamb":
            times[k] = times[k] / mp
    act_bytes = batch * seq * arch.d_model * dtype_bytes
    t_comm = 4 * arch.num_layers * ring_allreduce_time(act_bytes, mp,
                                                       dev.ici_bw)
    return DistProfile(name=f"MP x{mp}", phase_times=times,
                       comm_time=t_comm,
                       comm_bytes=4 * arch.num_layers * act_bytes)


def single(arch: ArchConfig, batch: int, seq: int,
           dev: DeviceSpec = MI100_FP32, dtype_bytes: int = 4) -> DistProfile:
    return DistProfile(name=f"Single B={batch}",
                       phase_times=phase_times(arch, batch, seq, dev,
                                               dtype_bytes),
                       comm_time=0.0, comm_bytes=0.0)


def figure12(arch: ArchConfig, seq: int = 128) -> Dict[str, DistProfile]:
    """The paper's Fig 12 set: S1, D1, D2 (64-way), M1 (2-way), M2
    (8-way)."""
    return {
        "S1 (single, B=16)": single(arch, 16, seq),
        "D1 (DP64 B=16, overlap)": data_parallel(arch, 16, seq, 64, True),
        "D2 (DP64 B=16, no overlap)": data_parallel(arch, 16, seq, 64, False),
        "M1 (MP2, B=16)": model_parallel(arch, 16, seq, 2),
        "M2 (MP8, B=64)": model_parallel(arch, 64, seq, 8),
    }
