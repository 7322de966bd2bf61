"""The sampler's kernels of two trees side by side, on the card.

    python3 sampler_compare.py ROOT [ROOT ...]

A development script beside ``chip_smoke.py``; no model path and no test
runs it. Each ROOT is the root of a checkout of this repository (an
unpacked ``git archive``, say); the script runs each in turn in a process
of its own, in the order given (name the parent and the change as parent,
change, change, parent to see drift), which builds that tree's kernels
and times its public wrappers (``fused_sampling.ops.filter_logits`` and
``draw_tokens``, ``fused_lm_head.ops.head_tokens``) on the same seeded
inputs: the filter on ``chip_smoke.py``'s 8 rows at llama3.2-3b's padded
vocab (128256), their first 4, the one row with top-k off and top-p 0.95,
and 8 rows at mamba2-1.3b's (50304); the draw on the filtered [8, 128256];
the fused head on llama's x [8, 3072] and W [128256, 3072] and mamba2's
[8, 2048] and [50304, 2048] (random bf16, chip_smoke.py's per-row
settings), filtered, sampled and greedy. Every time is device time a call
from torch.profiler over 40 calls (all kernels of the call). The card's
name and power limit come first; the last line is one JSON object:
``{"card": ..., "runs": [{"root": ..., "device_ms": {case: ms}}, ...]}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

NAMES = {"filter": ("filter_kernel",), "draw": ("draw_kernel",),
         "head": ("head_gemv_kernel", "head_epilogue_kernel")}


def device_ms(fn, names, iters: int = 40, tries: int = 3) -> float:
    """Device ms a call of the kernels whose names contain one of
    ``names``, from torch.profiler (a window in which the profiler
    delivered no kernel record, as happens now and then, is taken again)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(n in e.key for n in names))
        if us > 0:
            return us / 1e3 / iters
    raise RuntimeError(f"the profiler recorded no {names} time")


def one(root: str) -> dict:
    """Time ``root``'s wrappers (run in a process of its own)."""
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_lm_head import ops as head_ops
    from repro_torch.kernels.fused_lm_head import ref as head_ref
    from repro_torch.kernels.fused_sampling import ops
    _build.build_all()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {}
    top_p = torch.tensor([0.95, 1.0, 0.95, 0.95, 0.5, 0.95, 1.0, 0.99],
                         device=dev)
    for v in (128256, 50304):
        lg = torch.as_tensor(rng.normal(size=(8, v)).astype(np.float32)
                             * 3.0, device=dev)
        lg[3, :40] = lg[3, 40]
        top_k = torch.tensor([40, 40, 0, 40, 1, 40, 0, v + 5],
                             dtype=torch.int32, device=dev)
        cases = {f"filter [8, {v}]": (lg, top_k, top_p)}
        if v == 128256:
            cases[f"filter [4, {v}]"] = (lg[:4], top_k[:4], top_p[:4])
            cases[f"filter [1, {v}] top-k off, top-p 0.95"] = (
                lg[2:3].contiguous(), top_k[2:3], top_p[2:3])
        for case, args in cases.items():
            out[case] = device_ms(lambda: ops.filter_logits(*args),
                                  NAMES["filter"])
        if v == 128256:
            lg_f = ops.filter_logits(lg, top_k, top_p)
            idx = torch.arange(8, device=dev)
            rs = head_ref.row_uniforms(idx + 11, idx * 37)
            out[f"draw [8, {v}]"] = device_ms(
                lambda: ops.draw_tokens(lg_f, rs), NAMES["draw"])
    gen = torch.Generator(device=dev).manual_seed(3)
    idx = torch.arange(8, device=dev)
    rs = head_ref.row_uniforms(idx + 11, idx * 37)
    temps = torch.tensor([0.0, 1.0, 0.8, 1.0, 0.0, 1.0, 1.3, 0.7],
                         device=dev)
    for arch, d, v in (("llama3.2-3b", 3072, 128256),
                       ("mamba2-1.3b", 2048, 50304)):
        w = torch.empty((v, d), device=dev).normal_(0.0, 0.02, generator=gen
                                                    ).bfloat16()
        x = torch.randn((8, d), generator=gen, device=dev).bfloat16()
        top_k = torch.tensor([0, 3, 40, 0, 0, 40, 1, v + 5],
                             dtype=torch.int32, device=dev)
        hp = torch.tensor([1.0, 0.95, 0.95, 1.0, 1.0, 0.9, 1.0, 0.5],
                          device=dev)
        for step, sampled, filtered in (("filtered", True, True),
                                        ("sampled", True, False),
                                        ("greedy", False, False)):
            out[f"head_tokens {arch} {step}"] = device_ms(
                lambda: head_ops.head_tokens(x, w, rs, temps, top_k, hp,
                                             sampled=sampled,
                                             filtered=filtered),
                NAMES["head"])
        del w
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("sampler_compare: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one(sys.argv[2])))
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    runs = []
    for root in sys.argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True,
                              text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"[compare] {root}: " + "; ".join(
            f"{k} {v:.5f}" for k, v in ms.items()))
        runs.append({"root": root, "device_ms": ms})
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
