"""Device specs and the three-term roofline, ported from
``repro.core.roofline``:

    compute_s    = flops_per_device / peak_flops
    memory_s     = bytes_per_device / hbm_bw
    collective_s = collective_bytes_per_device / link_bw

plus ``collective_wire_s``, which applies ring-algorithm wire factors per
collective and routes pod-crossing groups over ``dcn_bw``. The JAX package
reads its byte counts from XLA's cost analysis and its collectives from the
compiled HLO (``hlotext``); here the caller passes them in, the
collectives as a ``Collectives`` record: ``characterize.analyze`` of a
step gives the FLOPs and bytes, and its ``summary().collectives()`` the
record (``optrace``, ``hlotext``'s counterpart).

The port's default device is the H100 (``H100``, ``H100_FP32``); the
paper's profiling GPU (``MI100``, ``MI100_FP32``) stays for the Fig. 4/5
breakdowns. The H100 specs are a pure roofline (no launch floor, full
bandwidth) until a measurement calibrates them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..configs.base import ArchConfig, ShapeConfig
from ..models.layers import pad_vocab


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    # defaults: one NVIDIA H100 SXM
    name: str = "h100-sxm"
    # bf16 dense tensor-core FLOP/s (NVIDIA H100 data sheet, SXM)
    peak_flops: float = 989e12
    # HBM3 bytes/s (NVIDIA H100 data sheet, SXM)
    hbm_bw: float = 3.35e12
    # NVLink 4: 900 GB/s a card, 450 GB/s each direction (NVIDIA H100 data
    # sheet, SXM)
    ici_bw: float = 450e9
    # one 400 Gb/s NDR InfiniBand port a card (NVIDIA DGX H100 data sheet:
    # ConnectX-7)
    dcn_bw: float = 50e9
    # HBM3 capacity (NVIDIA H100 data sheet, SXM)
    hbm_bytes: float = 80e9
    # per-kernel launch/latency floor: ~8us on the paper's GPU stack (the
    # reason its measured non-GEMM shares exceed a pure-bandwidth roofline)
    kernel_overhead: float = 0.0
    # achieved fraction of peak bandwidth for strided/small EW kernels
    ew_bw_efficiency: float = 1.0


H100 = DeviceSpec()
# fp32 outside the tensor cores (NVIDIA H100 data sheet, SXM)
H100_FP32 = DeviceSpec(name="h100-sxm-fp32", peak_flops=67e12)

# the paper's profiling GPU, for Fig 4/5-style breakdown comparisons; its
# dcn_bw is the JAX package's default (the paper's figures do not read it)
MI100 = DeviceSpec(name="mi100", peak_flops=184.6e12, hbm_bw=1228e9,
                   ici_bw=32e9, dcn_bw=6.25e9, hbm_bytes=32e9,
                   kernel_overhead=8e-6, ew_bw_efficiency=0.6)
MI100_FP32 = DeviceSpec(name="mi100-fp32", peak_flops=23.1e12, hbm_bw=1228e9,
                        ici_bw=32e9, dcn_bw=6.25e9, hbm_bytes=32e9,
                        kernel_overhead=8e-6, ew_bw_efficiency=0.6)


@dataclasses.dataclass(frozen=True)
class Collectives:
    """The per-device collective traffic ``compute_terms`` reads: operand
    bytes, and ring-model wire bytes over the device links and across
    pods."""
    operand_bytes: float = 0.0
    wire_bytes_ici: float = 0.0
    wire_bytes_dcn: float = 0.0


@dataclasses.dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    collective_wire_s: float
    dominant: str
    model_flops: float
    useful_ratio: float                  # MODEL_FLOPS / (flops * n_devices)
    step_s: float                        # max of the three terms
    peak_fraction: float                 # model_flops / (chips*peak) / step_s

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def matmul_params(arch: ArchConfig) -> float:
    """Active params that participate in GEMMs (embedding lookup excluded)."""
    active = arch.param_count(active_only=True)
    emb = pad_vocab(arch.vocab_size) * arch.d_model
    if arch.tie_embeddings:
        return float(active)            # the single table is also the head
    return float(active - emb)          # drop the lookup-only embedding table


def model_flops(arch: ArchConfig, shape: ShapeConfig) -> float:
    """6*N*D (train) / 2*N*D (inference) with N = active matmul params."""
    p = matmul_params(arch)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * p * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * p * tokens
    tokens = shape.global_batch          # decode: one token per sequence
    return 2.0 * p * tokens


def compute_terms(*, flops_per_device: float, bytes_per_device: float,
                  colls: Collectives, n_devices: int,
                  arch: ArchConfig, shape: ShapeConfig,
                  dev: DeviceSpec = H100) -> RooflineTerms:
    compute_s = flops_per_device / dev.peak_flops
    memory_s = bytes_per_device / dev.hbm_bw
    collective_s = colls.operand_bytes / dev.ici_bw
    wire_s = (colls.wire_bytes_ici / dev.ici_bw
              + colls.wire_bytes_dcn / dev.dcn_bw)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": max(collective_s, wire_s)}
    dominant = max(terms, key=terms.get)
    mf = model_flops(arch, shape)
    total_flops = flops_per_device * n_devices
    useful = mf / total_flops if total_flops else 0.0
    step_s = max(terms.values())
    ideal_s = mf / (n_devices * dev.peak_flops)
    return RooflineTerms(
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        collective_bytes_per_device=colls.operand_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        collective_wire_s=wire_s, dominant=dominant, model_flops=mf,
        useful_ratio=useful, step_s=step_s,
        peak_fraction=(ideal_s / step_s) if step_s > 0 else 0.0)
