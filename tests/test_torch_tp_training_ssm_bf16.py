"""How far a model axis moves mamba2's bf16 step, against how far bf16
itself moves it: the smoke mixer of mamba2-1.3b at 16 layers in
bfloat16 (B8 / S64, fp32 master weights, one step from the same seeded
weights and batch), step 1's ``m`` (the gradient) of a (1, 2) mesh of gloo
ranks against one device's bf16 step, and one device's bf16 step against
its float32 step, a leaf at a time (rel-L2). The mesh sums its
``in_proj`` / ``out_proj`` partial products in fp32 and rounds them once
(``Parallel.column`` / ``row``), so it rounds elsewhere than one device
(the order of those sums, the split gated norm's statistic) but not
more often: its gap to one device in the same dtype stays within phase
8d's m gate of ``chip_smoke.py`` at every leaf and its median under half
of bf16's own gap to fp32. With each rank's partial product rounded to
bf16 before the sum (``Parallel.enter`` / ``exit`` around the products)
the median read 0.045 and the largest leaf 0.17, against 0.016 and 0.039
with the fp32 sums; ``pytest -s`` prints the readings.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch import tree
from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.launch import mesh
from repro_torch.models.convert import assemble
from repro_torch.models.model import init_params

LAYERS, B, S = 16, 8, 64
TP_MOMENT_REL_L2 = 0.05     # chip_smoke.py's phase 8d m gate
_CACHE = {}


def _case(dtype):
    arch = dataclasses.replace(smoke_config("mamba2-1.3b"),
                               num_layers=LAYERS, dtype=dtype)
    params = tree.map(lambda t: t.numpy(), init_params(
        arch, torch.Generator().manual_seed(0), "cpu", torch.float32))
    data = SyntheticPipeline(DataConfig(
        vocab_size=arch.vocab_size, seq_len=S, global_batch=B,
        objective="causal", seed=1))
    return {"arch": arch, "params": params,
            "shape": dict(name="t", seq_len=S, global_batch=B, kind="train"),
            "run": dict(optimizer="lamb", learning_rate=1e-3, zero1=True,
                        fused_optimizer_kernel=False),
            "batches": [data.batch(0)]}


def _rel(a, b):
    return [float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30))
            for x, y in zip(a, b)]


def _readings():
    if "r" not in _CACHE:
        bf16 = _case("bfloat16")
        ranks = mesh.spawn(torch_ranks.step1_m, 2, bf16, backend="gloo",
                           device="cpu", mesh=((1, 2), ("data", "model")),
                           timeout=600)
        lead = ranks[0]
        whole = assemble([r["m"] for r in ranks],
                         [r["coords"] for r in ranks], lead["specs"],
                         bf16["arch"], lead["sizes"])
        one = torch_ranks.step1_m(None, 0, "cpu", bf16)
        fp32 = torch_ranks.step1_m(None, 0, "cpu", _case("float32"))
        one_m = [np.asarray(t) for t in tree.leaves(one["m"])]
        _CACHE["r"] = {
            "mesh": _rel([t.numpy() for t in tree.leaves(whole)], one_m),
            "one": _rel(one_m, [np.asarray(t) for t in tree.leaves(
                fp32["m"])]),
            "losses": (lead["loss"], one["loss"], fp32["loss"])}
    return _CACHE["r"]


def test_mesh_rounds_no_coarser_than_one_device():
    r = _readings()
    mesh_med, one_med = np.median(r["mesh"]), np.median(r["one"])
    print(f"\nmamba2 smoke, {LAYERS} layers, step-1 m rel-L2 a leaf: (1, 2) "
          f"mesh against one device, both bf16, median {mesh_med:.4g} max "
          f"{max(r['mesh']):.4g}; one device bf16 against fp32 median "
          f"{one_med:.4g} max {max(r['one']):.4g}; losses (mesh, one, "
          f"fp32) {r['losses']}")
    assert max(r["mesh"]) <= TP_MOMENT_REL_L2
    assert mesh_med <= 0.5 * one_med
    assert abs(r["losses"][0] - r["losses"][1]) < 1e-3 * r["losses"][1]
    assert abs(r["losses"][0] - r["losses"][2]) < 1e-2 * r["losses"][2]
