"""How the model axis's partial sums move mamba2-1.3b's bf16 step 1, on
the card, against depth.

    python3 mesh_rounding_ablations.py

A development script beside ``chip_smoke.py``; no model path and no test
runs it. At each depth of ``DEPTHS`` it takes phase 8b's mesh-free eager
step 1 (A: full width, B8 S128, fused, LAMB kernels, fp32 master, seeded
weights and batch) and holds against it, a leaf at a time (step 1's m and
master update, rel-L2; ``chip_smoke._mp_gates`` names the phase 8d gates
each fails):

- one device with the (1, 2) mesh's two partial sums a layer copied in
  (``chip_smoke._mamba_mesh_sums``, phase 8e's witness): ``fp32``, each model rank's
  ``out_proj`` and ``in_proj`` input-gradient partial product in fp32,
  summed and rounded once (what ``Parallel.column`` / ``row`` do), and
  ``bf16``, each partial rounded to bf16 before the fp32 sum (what the
  mixer did through ``Parallel.enter`` / ``exit`` around bf16 products);
- one device at two micro-batches of four rows (``micro2``): the
  gradients summed in another order, the forward unchanged;
- the (1, 2) mesh of two gloo ranks sharing the card, ``fp32`` (the
  mixer as it is) and ``bf16`` (``Parallel.column`` / ``row`` replaced by
  ``enter`` / ``exit`` around the products), each against A and against
  the one-device copy of its own sums; and the mesh with model rank 1's
  share of the gated norm's statistic dropped (``control``).

It prints one ``[rounding]`` line a comparison and the card's name and
power limit; it fails only where a run fails.
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

HERE = os.path.dirname(os.path.abspath(__file__))
DEPTHS = (12, 24, 48)


class _Bf16SumsIn(torch.autograd.Function):
    """``chip_smoke._MeshSumsIn`` with each rank's partial rounded to bf16
    before the sum."""
    @staticmethod
    def forward(ctx, u, w, cols):
        ctx.save_for_backward(u, w)
        ctx.cols = cols
        return u @ w

    @staticmethod
    def backward(ctx, g):
        u, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gu = sum((g2[:, c] @ w[:, c].t()).float() for c in ctx.cols)
        return (gu.to(u.dtype).reshape(u.shape),
                u.reshape(-1, u.shape[-1]).t() @ g2, None)


class _Bf16SumsOut(torch.autograd.Function):
    """``chip_smoke._MeshSumsOut`` with each rank's partial rounded to
    bf16 before the sum."""
    @staticmethod
    def forward(ctx, y, w):
        ctx.save_for_backward(y, w)
        y2, h = y.reshape(-1, y.shape[-1]), w.shape[0] // 2
        out = (y2[:, :h] @ w[:h]).float() + (y2[:, h:] @ w[h:]).float()
        return out.to(y.dtype).reshape(*y.shape[:-1], -1)

    @staticmethod
    def backward(ctx, g):
        y, w = ctx.saved_tensors
        return (g @ w.t(), y.reshape(-1, y.shape[-1]).t()
                @ g.reshape(-1, g.shape[-1]))


def _micro2_bundle(arch, fused):
    """``chip_smoke._family_bundle`` at two micro-batches."""
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.train.steps import build_train_step
    return build_train_step(RunConfig(
        arch=arch, shape=ShapeConfig("chip", seq_len=cs.TRAIN_SEQ,
                                     global_batch=cs.TRAIN_BATCH,
                                     kind="train", microbatches=2),
        optimizer="lamb", learning_rate=1e-3, zero1=False,
        fused_optimizer_kernel=fused, master_weights=True), "cuda")


def _save(arch, depth, kind):
    """One device's step 1 of ``kind`` ("A", "fp32", "bf16" or "micro2")
    through ``chip_smoke._eager_with_reference`` -> its step-1 files and
    loss."""
    from repro_torch.models import ssm
    keep = (ssm._apply_mamba, cs._MeshSumsIn, cs._MeshSumsOut,
            cs._family_bundle)
    if kind in ("fp32", "bf16"):
        ssm._apply_mamba = cs._mamba_mesh_sums
    if kind == "bf16":
        cs._MeshSumsIn, cs._MeshSumsOut = _Bf16SumsIn, _Bf16SumsOut
    if kind == "micro2":
        cs._family_bundle = _micro2_bundle
    ref = {k: os.path.join(cs._mpf_dir(), f"rounding_{depth}_{kind}_{k}.pt")
           for k in ("update", "m")}
    try:
        run = cs._eager_with_reference("mamba2-1.3b", arch, ref, steps=1)
    finally:
        (ssm._apply_mamba, cs._MeshSumsIn, cs._MeshSumsOut,
         cs._family_bundle) = keep
    ref["loss"] = run["losses"][0]
    cs._free(run)
    return ref


def _against(other, ref) -> dict:
    """Each leaf's m and update rel-L2 of the files ``other`` against
    ``ref``, and the update norms' ratio."""
    out = {"update": [], "m": [], "norm": []}
    loads = [torch.load(f[k], mmap=True) for f in (other, ref)
             for k in ("update", "m")]
    for u, m, ru, rm in zip(*loads):
        u, m, ru, rm = (t.cuda().double() for t in (u, m, ru, rm))
        ref_norm = torch.linalg.vector_norm(ru).clamp_min(1e-60)
        out["update"].append(float(torch.linalg.vector_norm(u - ru)
                                   / ref_norm))
        out["m"].append(float(torch.linalg.vector_norm(m - rm) /
                              torch.linalg.vector_norm(rm).clamp_min(1e-60)))
        out["norm"].append(float(torch.linalg.vector_norm(u) / ref_norm))
    return out


def _rank(mesh, rank, device, specs):
    """``chip_smoke._mp_train`` a spec at a time, ``bf16`` specs with the
    mixer's products through ``Parallel.enter`` / ``exit``."""
    from repro_torch.parallel import collectives
    fp32 = (collectives.Parallel.column, collectives.Parallel.row)
    outs = []
    for spec in specs:
        if spec.pop("sums") == "bf16":
            collectives.Parallel.column = lambda self, x, w: self.enter(x) @ w
            collectives.Parallel.row = lambda self, y, w: self.exit(y @ w)
        else:
            collectives.Parallel.column, collectives.Parallel.row = fp32
        outs += cs._mp_train(mesh, rank, device, [spec])
    return outs


def _line(depth, what, rd, loss_gap):
    print(f"[rounding] {depth} layers, {what}: loss {loss_gap:.3f} bf16 "
          f"ulps; m rel-L2 max {max(rd['m']):.4g}, median "
          f"{float(np.median(rd['m'])):.4g}; update rel-L2 max "
          f"{max(rd['update']):.4g}, median "
          f"{float(np.median(rd['update'])):.4g}; phase 8d gates failed "
          f"{sorted(cs._mp_gates(rd))}", flush=True)


def _remove(*refs) -> None:
    for ref in refs:
        for k in ("update", "m"):
            os.remove(ref[k])


def _ulps(loss, ref) -> float:
    return abs(loss - ref["loss"]) / cs._bf16_ulp(
        torch.tensor(ref["loss"])).item()


def main() -> int:
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("mesh_rounding_ablations: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()
    os.environ["REPRO_FUSED_BLOCKS"] = "1"
    full = get_config("mamba2-1.3b")
    for depth in DEPTHS:
        t0 = time.perf_counter()
        arch = dataclasses.replace(full, num_layers=depth)
        a = _save(arch, depth, "A")
        one = {}
        for kind in ("micro2", "fp32", "bf16"):
            one[kind] = _save(arch, depth, kind)
            _line(depth, f"one device, {kind} against A",
                  _against(one[kind], a), _ulps(one[kind]["loss"], a))
            if kind == "micro2":
                _remove(one.pop(kind))
        strip = ("update", "m")
        base = {"arch": "mamba2-1.3b", "layers": depth, "rules": {},
                "steps": 1}
        runs = [("fp32", a, "A"), ("fp32", one["fp32"], "its copy"),
                ("bf16", a, "A"), ("bf16", one["bf16"], "its copy"),
                ("control", a, "A")]
        specs = [dict(base, sums="fp32" if s == "control" else s,
                      ref={k: r[k] for k in strip})
                 for s, r, _ in runs]
        specs[-1]["control"] = "statistic"
        ranks = mesh_lib.spawn(_rank, 2, specs, backend="gloo",
                               device="cuda",
                               mesh=((1, 2), ("data", "model")),
                               timeout=900)
        for i, (sums, ref, name) in enumerate(runs):
            lead, rd, _ = cs._mp_check_run(ranks, i, f"{depth} {sums}")
            _line(depth, f"(1, 2) mesh, {sums}, against {name}", rd,
                  _ulps(lead["losses"][0], ref))
        _remove(a, *one.values())
        print(f"[rounding] {depth} layers: {time.perf_counter() - t0:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
