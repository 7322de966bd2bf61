"""What each part of the bias + GeLU kernel's design buys, on the card.

    python3 gelu_ablations.py [--parent ROOT]

A development script beside ``chip_smoke.py``; no model path and no test
runs it. It times ``bias_gelu``
(``src/repro_torch/kernels/bias_gelu/csrc/bias_gelu.cu``) at bert-large's
MLP shapes, [1024, 4096] (B8, S128) and [4096, 4096] (B8, S512), bf16 x and
bias, as built with the plan ``ops.gelu_plan`` picks, then one change at a
time:
- source variants made by text substitutions, each of which must match the
  source exactly once: GeLU through ``tanhf`` (the full-precision tanh
  form), the reciprocal as an IEEE division, evict-first (streaming)
  hints on the loads of x and the stores of y, on both or on one, the next
  rows' loads issued after this rows' stores instead of before its math,
  and 1, 2 or 8 rows in flight a thread instead of 4;
- other grids through the same build: about 1, 2, 8 and 16 CTAs a SM
  instead of 4, and one row a thread (2048 elements a CTA, the grid of
  the first kernel);
- with ``--parent ROOT`` (the root of a checkout of an earlier tree, an
  unpacked ``git archive`` say), that tree's ``bias_gelu.cu`` built and
  launched through its own C entry (the first kernel: one 8-element chunk
  a thread, a 64-bit remainder for the bias column, ``tanhf``; its entry
  takes (x, b, y, n, f, bias_f32, stream)).
Beside them, ``F.gelu(approximate="tanh")`` of a precomputed bf16 sum (the
activation only, one launch) and the plain version (add, then ``F.gelu``).
Every time is device time a call from torch.profiler over 40 calls on the
same x (warm in L2 where it fits, as the GEMM before it leaves it in the
step), the
lesser of two rounds that each run every entry in turn; every run's output
is held to the plain version run in fp32 on the same bf16 inputs, within
1 bf16 ulp + |h| 2^-22 (``chip_smoke.py``'s gate), also on a tail-heavy
input (h spread over [-12, 12]); the script fails on a miss.

The card's name and power limit come first; the last line is one JSON
object of the results.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL = "bias_gelu_kernel"

_GELU = ("  const float e = ex2_approx(h * fmaf(kB, h * h, kA));\n"
         "  return __fdividef(h, 1.0f + e);\n")
_IN_FLIGHT = "constexpr int kRowsInFlight = 4;"
_LOAD_CS = ("xp[j * stride];\n  for (int r", "__ldcs(xp + j * stride);\n  for (int r")
_LOAD_NEXT_CS = ("next[j] = xp[(kRowsInFlight + j) * stride];",
                 "next[j] = __ldcs(xp + (kRowsInFlight + j) * stride);")
_STORE_CS = ("yp[j * stride] = gelu8(raw[j], bv);",
             "__stcs(yp + j * stride, gelu8(raw[j], bv));")
# this rows' loads only, the next rows' after this rows' stores
_PREFETCH = """  uint4 raw[kRowsInFlight];
  int n = min(kRowsInFlight, r1 - r0);
#pragma unroll
  for (int j = 0; j < kRowsInFlight; ++j)
    if (j < n) raw[j] = xp[j * stride];
  for (int r = r0; r < r1; r += kRowsInFlight) {
    // the next rows' loads go out before this rows' math and stores
    const int n_next = min(kRowsInFlight, r1 - r - kRowsInFlight);
    uint4 next[kRowsInFlight];
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j)
      if (j < n_next) next[j] = xp[(kRowsInFlight + j) * stride];
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j)
      if (j < n) yp[j * stride] = gelu8(raw[j], bv);
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j)
      if (j < n_next) raw[j] = next[j];
    n = n_next;
"""
_NO_PREFETCH = """  for (int r = r0; r < r1; r += kRowsInFlight) {
    const int n = min(kRowsInFlight, r1 - r);
    uint4 raw[kRowsInFlight];
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j)
      if (j < n) raw[j] = xp[j * stride];
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j)
      if (j < n) yp[j * stride] = gelu8(raw[j], bv);
"""
VARIANTS = {
    "GeLU by tanhf": [(_GELU, "  return 0.5f * h * (1.0f + tanhf("
                              "0.7978845608028654f * (h + 0.044715f * h * h"
                              " * h)));\n")],
    "IEEE division": [("return __fdividef(h, 1.0f + e);",
                       "return h / (1.0f + e);")],
    "evict-first hints on x and y": [_LOAD_CS, _LOAD_NEXT_CS, _STORE_CS],
    "evict-first hint on x": [_LOAD_CS, _LOAD_NEXT_CS],
    "evict-first hint on y": [_STORE_CS],
    "the next rows' loads after this rows' stores": [(_PREFETCH,
                                                      _NO_PREFETCH)],
    **{f"{n} rows in flight": [(_IN_FLIGHT,
                                f"constexpr int kRowsInFlight = {n};")]
       for n in (1, 2, 8)},
}
AS_BUILT = "as built"
PARENT = "parent kernel"
SHAPES = ((1024, 4096), (4096, 4096))
GELU_TAIL = 2.0 ** -22


def variant_source(text: str, subs) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"ablation text not found once: {old!r}")
        text = text.replace(old, new)
    return text


def build(_build, parent) -> dict:
    """Every variant's library, all nvcc runs at once: {variant: library
    name under build/repro_torch/}."""
    _build.build_all()
    out_dir = _build.BUILD_DIR / "ablations"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.sources()["bias_gelu"]
    texts = {name: variant_source(src.read_text(), subs)
             for name, subs in VARIANTS.items()}
    if parent:
        texts[PARENT] = open(os.path.join(
            parent, "src/repro_torch/kernels/bias_gelu/csrc/bias_gelu.cu")
        ).read()
    procs, libs = {}, {AS_BUILT: "bias_gelu"}
    for i, (name, text) in enumerate(texts.items()):
        lib = libs[name] = f"gelu_ablation{i}"
        path = out_dir / f"{lib}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(_build.BUILD_DIR / f"{lib}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        regs = [ln.split("info    : ")[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {regs}")
    return libs


def device_ms(fn, name: str, iters: int = 40, tries: int = 3) -> float:
    """Device ms a call of the kernels whose names contain ``name`` ("" for
    every kernel), from torch.profiler; a window whose record count is not
    ``iters`` times a one-call window's (the profiler drops records now
    and then) is taken again."""
    from torch.profiler import ProfilerActivity, profile

    def window(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and name in e.key]
        return (sum(e.count for e in hits),
                sum(e.self_device_time_total for e in hits) / 1e3 / n)
    for _ in range(tries):
        one, _ = window(1)
        count, ms = window(iters)
        if one and count == one * iters:
            return ms
    raise RuntimeError(f"the profiler did not record {iters} windows of "
                       f"{name!r} kernels")


def inputs(rows, f, dev, tail=False):
    """Seeded bf16 x [rows, f] and bias [f] (chip_smoke.py's scales); with
    ``tail`` x spread uniformly so that h covers [-12, 12]."""
    gen = torch.Generator(device=dev).manual_seed(rows + f)
    b = (0.5 * torch.randn((f,), generator=gen, device=dev)).bfloat16()
    if tail:
        x = (24 * torch.rand((rows, f), generator=gen, device=dev) - 12
             - b.float()).bfloat16()
    else:
        x = (2 * torch.randn((rows, f), generator=gen, device=dev)).bfloat16()
    return x, b


def gate(y, x, b) -> float:
    """The worst |y - plain in fp32| over 1 bf16 ulp + |h| 2^-22; the
    script exits if it exceeds 1."""
    from repro_torch.kernels.bias_gelu import ref
    h = x.float() + b.float()
    p = ref.bias_gelu(x.float(), b.float()).bfloat16().float()
    ulp = torch.exp2(torch.floor(torch.log2(
        p.abs().clamp_min(2.0 ** -126))) - 7)
    return ((y.float() - p).abs() / (ulp + h.abs() * GELU_TAIL)).max().item()


def ablate(parent) -> dict:
    import torch.nn.functional as F
    from repro_torch.core.roofline import H100
    from repro_torch.kernels import _build
    from repro_torch.kernels.bias_gelu import ops, ref
    libs = build(_build, parent)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = {}
    for rows, f in SHAPES:
        picked = ops.gelu_plan(rows, f, sms)
        runs = {f"{name}, plan {tuple(picked)}": (lib, picked)
                for name, lib in libs.items() if name != PARENT}
        for per_sm in (1, 2, 8, 16):
            gy = max(1, -(-sms * per_sm // picked.gx))
            per = -(-rows // gy)
            plan = picked._replace(gy=-(-rows // per), rows_per_thread=per)
            runs[f"{AS_BUILT}, about {per_sm} CTAs a SM, plan "
                 f"{tuple(plan)}"] = (libs[AS_BUILT], plan)
        one_row = picked._replace(gy=rows, rows_per_thread=1)
        runs[f"{AS_BUILT}, one row a thread, plan {tuple(one_row)}"] = (
            libs[AS_BUILT], one_row)
        cases = {"random": inputs(rows, f, dev),
                 "tail-heavy": inputs(rows, f, dev, tail=True)}
        x, b = cases["random"]
        y = torch.empty_like(x)

        def launch(lib, plan, xx, bb, yy):
            if plan is None:            # the parent's entry
                fn = _build.bind(lib, "bias_gelu", 3, 3)
                _build.check(fn(xx.data_ptr(), bb.data_ptr(), yy.data_ptr(),
                                xx.numel(), f, 0,
                                torch.cuda.current_stream().cuda_stream),
                             "parent bias_gelu")
            else:
                ops._launch(xx, bb, yy, plan, lib=lib)
        if PARENT in libs:
            runs[PARENT] = (libs[PARENT], None)
        best = results.setdefault(f"[{rows}, {f}]", {"plan": picked._asdict()})
        hb = x + b
        yard = {"F.gelu of a precomputed sum":
                lambda: F.gelu(hb, approximate="tanh"),
                "plain version (add, then F.gelu)":
                lambda: ref.bias_gelu(x, b)}
        for rnd in range(2):
            for label, (lib, plan) in runs.items():
                worst = 0.0
                for xx, bb in cases.values():
                    launch(lib, plan, xx, bb, y)
                    torch.cuda.synchronize()
                    worst = max(worst, gate(y, xx, bb))
                if not worst <= 1.0:
                    raise SystemExit(f"gelu_ablations: [{rows}, {f}] {label}: "
                                     f"{worst} of the gate")
                ms = device_ms(lambda: launch(lib, plan, x, b, y), KERNEL)
                print(f"[ablation] round {rnd} | [{rows}, {f}] | {label}: "
                      f"device {ms:.6f} ms, worst {worst:.3f} of the gate")
                if ms < best.get(label, {}).get("device_ms", float("inf")):
                    best[label] = {"device_ms": ms, "worst_of_gate": worst}
            for label, fn in yard.items():
                ms = device_ms(fn, "")
                print(f"[ablation] round {rnd} | [{rows}, {f}] | {label}: "
                      f"device {ms:.6f} ms")
                best[label] = min(best.get(label, ms), ms)
        best["byte bound ms"] = (2 * rows * f * 2 + f * 2) / H100.hbm_bw * 1e3
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("gelu_ablations: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    parent = None
    if len(sys.argv) > 2 and sys.argv[1] == "--parent":
        parent = os.path.abspath(sys.argv[2])
    sys.path.insert(0, os.path.join(HERE, "src"))
    print(json.dumps({"card": smi, "ablations": ablate(parent)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
