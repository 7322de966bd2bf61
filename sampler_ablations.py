"""What the sampler's cluster design buys, on the card.

    python3 sampler_ablations.py [--parent ROOT]

A development script beside ``chip_smoke.py``; no model path and no test
runs it. Every variant is the sampler's own sources
(``src/repro_torch/kernels/fused_sampling/csrc/{sampling.cu,
sampling_device.cuh}`` and ``fused_lm_head/csrc/head_tokens.cu``, which
includes the header) with one part of the design changed by text
substitutions, each of which must match its file exactly once (the script
fails when the sources have moved away from them): 8 or 32 nucleus
candidates a sweep instead of 16 (a sweep's cost against the number of
sweeps); rank 0 receiving one rank's sweep partials a round instead of
all that fit (what the rounds of a row too wide for one cost); the draw's in-tile prefix sums loading one word at a time
instead of 16 (a chain of loads against a chain of adds); folds that load
16 terms ahead instead of 8 (registers against latency); no estimate (the first exact sweep around the middle key); a
second cluster barrier in every exact sweep (what one barrier costs,
timing only); and phase stamps (timing only): thread 0 of the first CTA of
the first row records ``clock64()`` at every phase of the filter, read
back after one call. The variant as built also runs at every
cluster size the card takes, the plan's (``ops.cluster_plan``) marked, and
the script prints how many clusters of each size the card runs at once
(``cudaOccupancyMaxActiveClusters``) at 128,256, 50,304 and 256,000
entries.

The draw section times the inverse-CDF draw (``draw_kernel``: a cluster a
row, its uniform computed on the card) at chip_smoke's 8 rows at llama's
vocab filtered and unfiltered, their first row, 16 rows, and 8 filtered
rows at mamba2's vocab, at the plan's cluster size and at every size in
``SIZES`` the shared memory takes, each output bitwise against the plain
draw of ``ref.row_uniforms``; with ``--parent ROOT`` (an unpacked ``git
archive`` of a tree whose draw is one CTA of 1024 threads a row reading
the row from device memory three times, fed the uniforms) that tree's
``sampling.cu`` is built too and its draw timed on the same rows beside
it; the prefix-sum variant at the plan's size; and the stamped variant's
cycles between the draw's phases (load, max, tile masses, fold with
prefix sums and uniform, search, least hit).

All variants are built at once with ``nvcc`` into ``build/repro_torch/``
and launched through the wrappers' launch helpers (``ops._launch_filter``,
``fused_lm_head.ops._launch``). Filter cases: ``chip_smoke.py``'s 8 rows
at llama3.2-3b's vocab (128256) and their first 4, one row of each kind
(top-k off with top-p 0.95, which searches the whole row; top-k 40 with
top-p 0.95; top-k 40 alone; neither), and 8 rows at mamba2's padded vocab
(50304), and command-r-35b's 256,000-entry rows: 8 of them, 16, and one
with top-k off and top-p 0.95, at every size from 11 to 16 CTAs (the
sizes whose shared memory holds such a row); each output bitwise against
``ref.filter_logits_bisect``. The draw also at [8, 256000], [1, 256000]
and [16, 256000] filtered. The fused head: llama's x [8, 3072] and W
[128256, 3072], mamba2's [8, 2048] and [50304, 2048] and command-r's [8,
8192] and [256000, 8192] on exact-arithmetic inputs (every logit exact in
fp32),
tokens bitwise against ``ref.head_tokens``, greedy, sampled and filtered
steps. Every time is device time a call from torch.profiler over 40 calls,
the lesser of two rounds that each run every variant in turn. The card's
name and power limit come first; the last line is one JSON object of the
results.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLING = "fused_sampling/csrc/sampling.cu"
HEADER = "fused_sampling/csrc/sampling_device.cuh"
HEAD = "fused_lm_head/csrc/head_tokens.cu"

_SYNC1 = "      const float sg = sweep_fold();\n"
_ROUND = ("      cluster.sync();                  // round j's partials in "
          "rank 0\n")
_STAMP_FN = (
    "namespace cg = cooperative_groups;\n\n"
    "__device__ long long g_stamp[64];\n"
    "__device__ int g_nstamp;\n"
    "__device__ __forceinline__ void stamp() {\n"
    "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
    "    const int n = g_nstamp;\n"
    "    if (n < 64) g_stamp[n] = clock64();\n"
    "    g_nstamp = n + 1;\n"
    "  }\n"
    "}\n")
_STAMP_EXPORT = (
    'extern "C" int sampler_stamps(void* out) {\n'
    "  int n = 0;\n"
    "  cudaMemcpyFromSymbol(out, sampling::g_stamp, sizeof(long long) * 64);\n"
    "  cudaMemcpyFromSymbol(&n, sampling::g_nstamp, sizeof(int));\n"
    "  const int zero = 0;\n"
    "  cudaMemcpyToSymbol(sampling::g_nstamp, &zero, sizeof(int));\n"
    "  return n;\n"
    "}\n\n"
    'extern "C" int draw_tokens(')

_DRAW_LOAD = ("  const float mx = crow.load_floats(logits + "
              "static_cast<size_t>(row) * vocab);\n")
_DRAW_MAX = "    if (lane == 0) sh.dmax = v;\n  }\n  cluster.sync();\n"
_DRAW_PARTS = ("    if (lane == 0) row.stage0[row.t0 + lt] = z;\n  }\n"
               "  cluster.sync();\n")
_DRAW_FOLD = ("            ut[4 * (h + q) + r] = c;\n          }\n        }\n"
              "      }\n    }\n  }\n  cluster.sync();\n")
_DRAW_HIT = ("  __syncthreads();\n"
             "  if (tid == 0 && sh.dlocal != 0xFFFFFFFFu)\n")
_DRAW_END = "  cluster.sync();\n  return sh.dmin"

_PREFIX_QUADS = """      float4 b;
      b.x = acc;
      acc = __fadd_rn(acc, cur[j].x);
      b.y = acc;
      acc = __fadd_rn(acc, cur[j].y);
      b.z = acc;
      acc = __fadd_rn(acc, cur[j].z);
      b.w = acc;
      acc = __fadd_rn(acc, cur[j].w);
      b4[q + j] = b;
"""
_PREFIX_SCALARS = """      const float t[4] = {cur[j].x, cur[j].y, cur[j].z, cur[j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        before[4 * (q + j) + e] = acc;
        acc = __fadd_rn(acc, t[e]);
      }
"""

# name: text substitutions (file, old, new) of the sources
VARIANTS = {
    "as built": [],
    "8 candidates": [(HEADER, "constexpr int kCand = 16;",
                      "constexpr int kCand = 8;")],
    "32 candidates": [(HEADER, "constexpr int kCand = 16;",
                       "constexpr int kCand = 32;")],
    "in-tile prefix sums loading one word at a time": [
        (HEADER, "constexpr int kScanAhead = 16;",
         "constexpr int kScanAhead = 1;")],
    "the draw's fold alone, no prefix sums beside it (timing)": [
        (HEADER, "  } else if (tid >= 32 && tid < kThreads - 32) {\n",
         "  } else if (false) {\n")],
    "the draw's fold storing each prefix alone": [
        (HEADER, _PREFIX_QUADS, _PREFIX_SCALARS)],
    "the draw's fold loading 32 terms ahead": [
        (HEADER, "constexpr int kPrefixAhead = 4;",
         "constexpr int kPrefixAhead = 8;")],
    "the draw's fold as the filter's (fold_run, 8 terms ahead)": [
        (HEADER, "    const float z = fold_prefix(row.stage, row.n_tiles, "
         "row.before);\n",
         "    const float z = fold_run(row.stage, row.n_tiles, 1, "
         "row.before);\n")],
    "receive one segment a round": [
        (HEADER, "  return fit < 1 ? 1 : fit < size - 1 ? fit : size - 1;",
         "  return 1;")],
    "folds loading 16 terms ahead": [
        (HEADER, "constexpr int kFoldAhead = 8;",
         "constexpr int kFoldAhead = 16;")],
    "no estimate (the first sweep around the middle key)": [
        (HEADER, "    const unsigned ke = estimate_key(t);\n",
         "    const unsigned ke = kTopKey / 2;\n")],
    "a second barrier each sweep (timing)": [
        (HEADER, _SYNC1, "      cluster.sync();\n" + _SYNC1)],
    "phase stamps (timing)": [
        (HEADER, "namespace cg = cooperative_groups;\n", _STAMP_FN),
        (HEADER, "  const float kth = key_to_float(kkey);\n",
         "  const float kth = key_to_float(kkey);\n  stamp();\n"),
        (HEADER, "    const float t = fmaxf(__fmul_rn(top_p, z), kTFloor);\n",
         "    const float t = fmaxf(__fmul_rn(top_p, z), kTFloor);\n"
         "    stamp();\n"),
        (HEADER, _SYNC1, "      stamp();\n" + _SYNC1),
        (HEADER, _ROUND, _ROUND + "      stamp();\n"),
        (HEADER, "      cluster.sync();\n      lo = sh.dec[0];\n",
         "      stamp();\n      cluster.sync();\n      lo = sh.dec[0];\n"
         "      stamp();\n"),
        (HEADER, "      above = sh.above;\n",
         "      above = sh.above;\n      stamp();\n"),
        (SAMPLING, "  crow.load([&](int i) { return x[i]; });\n",
         "  sampling::stamp();\n  crow.load([&](int i) { return x[i]; });\n"
         "  sampling::stamp();\n"),
        (SAMPLING, "  cluster.sync();            // no CTA leaves",
         "  sampling::stamp();\n  cluster.sync();            // no CTA leaves"),
        (SAMPLING, 'extern "C" int draw_tokens(', _STAMP_EXPORT),
        (SAMPLING, _DRAW_LOAD, "  sampling::stamp();\n" + _DRAW_LOAD
         + "  sampling::stamp();\n"),
        (HEADER, _DRAW_MAX, _DRAW_MAX + "  stamp();\n"),
        (HEADER, _DRAW_PARTS, _DRAW_PARTS + "  stamp();\n"),
        (HEADER, _DRAW_FOLD, _DRAW_FOLD + "  stamp();\n"),
        (HEADER, _DRAW_HIT, _DRAW_HIT + "  stamp();\n"),
        (HEADER, _DRAW_END, _DRAW_END.replace("  return", "  stamp();\n"
                                              "  return"))],
}
AS_BUILT = "as built"
DRAW_VARIANTS = ("in-tile prefix sums loading one word at a time",
                 "the draw's fold alone, no prefix sums beside it (timing)",
                 "the draw's fold storing each prefix alone",
                 "the draw's fold loading 32 terms ahead",
                 "the draw's fold as the filter's (fold_run, 8 terms ahead)")
TIMING_ONLY = ("a second barrier each sweep (timing)", "phase stamps (timing)",
               "the draw's fold alone, no prefix sums beside it (timing)")
SIZES = [4, 8, 12, 16]
WIDE = 256000               # command-r-35b's rows: 11-16 CTAs hold one
WIDE_SIZES = list(range(11, 17))


def variant_sources(root: Path, subs) -> dict:
    texts = {f: (root / f).read_text() for f in (SAMPLING, HEADER, HEAD)}
    for f, old, new in subs:
        if texts[f].count(old) != 1:
            raise ValueError(f"ablation text not found once in {f}: {old!r}")
        texts[f] = texts[f].replace(old, new)
    return texts


def build(_build) -> dict:
    """Every variant's two libraries, all nvcc runs at once: name ->
    (filter library, head library) under ``build/repro_torch/``."""
    root = _build.KERNELS_DIR
    out_dir = _build.BUILD_DIR / "ablations"
    procs, libs = {}, {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        vdir = out_dir / f"sampler{i}"
        for f, text in variant_sources(root, subs).items():
            (vdir / f).parent.mkdir(parents=True, exist_ok=True)
            (vdir / f).write_text(text)
        libs[name] = (f"sampler_ablation{i}", f"sampler_head_ablation{i}")
        for lib, f in zip(libs[name], (SAMPLING, HEAD)):
            procs[(name, lib)] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                 str(_build.BUILD_DIR / f"{lib}.so"), str(vdir / f)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for (name, lib), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r} ({lib}):\n{log}")
        regs = [ln.split("info    : ")[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {name} ({lib}): {regs}")
    return libs


def device_ms(fn, names, iters: int = 40, tries: int = 5) -> float:
    """Device ms a call of the kernels whose names contain one of
    ``names``, from torch.profiler (a window in which the profiler
    delivered no kernel record, as happens now and then, is taken again:
    three tries were once not enough after some 500 windows)."""
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
    raise RuntimeError(f"the profiler recorded no {names} time: "
                       f"{[e.key for e in prof.key_averages()]}")


def filter_cases(dev, rng):
    """name -> (logits, top_k, top_p)."""
    v = 128256
    lg = torch.as_tensor(rng.normal(size=(8, v)).astype(np.float32) * 3.0,
                         device=dev)
    lg[3, :40] = lg[3, 40]                 # ties across the k-th value
    top_k = [40, 40, 0, 40, 1, 40, 0, v + 5]
    top_p = [0.95, 1.0, 0.95, 0.95, 0.5, 0.95, 1.0, 0.99]

    def rows(x, ks, ps):
        return (x.contiguous(),
                torch.tensor(ks, dtype=torch.int32, device=dev),
                torch.tensor(ps, dtype=torch.float32, device=dev))
    cases = {"[8, 128256] chip_smoke rows": rows(lg, top_k, top_p),
             "[4, 128256]": rows(lg[:4], top_k[:4], top_p[:4])}
    for name, k, p in (("top-k off, top-p 0.95", 0, 0.95),
                       ("top-k 40, top-p 0.95", 40, 0.95),
                       ("top-k 40 alone", 40, 1.0),
                       ("neither", 0, 1.0)):
        cases[f"[1, 128256] {name}"] = rows(lg[:1], [k], [p])
    vm = 50304
    lm = torch.as_tensor(rng.normal(size=(8, vm)).astype(np.float32) * 3.0,
                         device=dev)
    cases["[8, 50304] chip_smoke rows"] = rows(
        lm, [40, 40, 0, 40, 1, 40, 0, vm + 5], top_p)
    lw = torch.as_tensor(rng.normal(size=(16, WIDE)).astype(np.float32)
                         * 3.0, device=dev)
    kw = [40, 40, 0, 40, 1, 40, 0, WIDE + 5]
    cases[f"[8, {WIDE}] chip_smoke rows"] = rows(lw[:8], kw, top_p)
    cases[f"[16, {WIDE}] chip_smoke rows twice"] = rows(lw, kw * 2,
                                                        top_p * 2)
    cases[f"[1, {WIDE}] top-k off, top-p 0.95"] = rows(lw[:1], [0], [0.95])
    return cases


def head_inputs(dev, d, v):
    """x [8, d] on k/8 and W [v, d] on k/64, |k| <= 8: every logit exact in
    fp32; the sampler's per-row settings of chip_smoke.py: (x, w, seeds,
    positions, temps, top_k, top_p)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    w = torch.randint(-8, 9, (v, d), generator=gen, device=dev,
                      dtype=torch.int8).to(torch.bfloat16) / 64
    x = torch.randint(-8, 9, (8, d), generator=gen, device=dev,
                      dtype=torch.int8).to(torch.bfloat16) / 8
    idx = torch.arange(8, device=dev)
    seeds, pos = idx + 11, (idx * 37).int()
    temps = torch.tensor([0.0, 1.0, 0.8, 1.0, 0.5, 1.0, 1.3, 0.7],
                         device=dev)
    top_k = torch.tensor([0, 3, 40, 0, 0, 40, 1, v + 5], dtype=torch.int32,
                         device=dev)
    top_p = torch.tensor([1.0, 0.95, 0.95, 1.0, 1.0, 0.9, 1.0, 0.5],
                         device=dev)
    return x, w, seeds, pos, temps, top_k, top_p


def stamps(lib_name: str, run) -> list:
    """Cycles between the phase stamps of one call (the stamped variant)."""
    from repro_torch.kernels import _build
    fn = getattr(_build.library(lib_name), "sampler_stamps")
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_longlong * 64)()
    torch.cuda.synchronize()
    fn(ctypes.addressof(buf))                # resets the count
    run()
    torch.cuda.synchronize()
    n = min(fn(ctypes.addressof(buf)), 64)
    return [buf[i + 1] - buf[i] for i in range(n - 1)]


def draw_rows(dev, rng) -> dict:
    """name -> [S, V] float32 rows for the draw."""
    from repro_torch.kernels.fused_sampling import ops
    cases = filter_cases(dev, rng)
    lg, tk, tp = cases["[8, 128256] chip_smoke rows"]
    lg_f = ops.filter_logits(lg, tk, tp)
    lm, tkm, tpm = cases["[8, 50304] chip_smoke rows"]
    lw, tkw, tpw = cases[f"[16, {WIDE}] chip_smoke rows twice"]
    lw_f = ops.filter_logits(lw, tkw, tpw)
    return {"[8, 128256] filtered": lg_f, "[8, 128256] unfiltered": lg,
            "[1, 128256] filtered": lg_f[:1].contiguous(),
            "[16, 128256] filtered": torch.cat([lg_f, lg_f]),
            "[8, 50304] filtered": ops.filter_logits(lm, tkm, tpm),
            f"[8, {WIDE}] filtered": lw_f[:8].contiguous(),
            f"[1, {WIDE}] filtered": lw_f[:1].contiguous(),
            f"[16, {WIDE}] filtered": lw_f}


def build_parent(_build, root: str) -> str:
    """``root``'s sampling.cu built as library "sampler_parent"."""
    src = (Path(root).resolve() / "src/repro_torch/kernels/fused_sampling/"
           "csrc/sampling.cu")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(_build.BUILD_DIR / "sampler_parent.so"),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return "sampler_parent"


def ablate_draw(libs, parent, dev) -> dict:
    """The draw section (module docstring)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_lm_head import ref as head_ref
    from repro_torch.kernels.fused_sampling import ops
    out = {}
    for case, lg in draw_rows(dev, np.random.default_rng(1)).items():
        s, v = lg.shape
        idx = torch.arange(s, device=dev)
        seeds, pos = idx + 11, (idx * 37).int()
        rs = head_ref.row_uniforms(seeds, pos)
        plain = head_ref.draw_tokens(lg, rs)
        planned = ops.cluster_plan(s, v)
        runs = {f"{AS_BUILT} ({planned} CTAs a row, the plan's)":
                (libs[AS_BUILT][0], planned)}
        for size in WIDE_SIZES if v == WIDE else SIZES:
            if size != planned and ops.cluster_smem_bytes(v, size) \
                    <= ops.SMEM_BYTES:
                runs[f"{AS_BUILT}, {size} CTAs a row"] = (libs[AS_BUILT][0],
                                                          size)
        for name in DRAW_VARIANTS:
            runs[name] = (libs[name][0], planned)
        stamped = "phase stamps (timing)"
        runs[stamped] = (libs[stamped][0], planned)
        if parent:
            runs["parent (one CTA a row)"] = (parent, None)
        best = out.setdefault(case, {})
        for rnd in range(2):
            for name, (lib, size) in runs.items():
                tok = torch.empty((s,), dtype=torch.int32, device=dev)
                if size is None:
                    fn = _build.bind(lib, "draw_tokens", 3, 2)

                    def run():
                        fn(lg.data_ptr(), rs.data_ptr(), tok.data_ptr(), s,
                           v, torch.cuda.current_stream().cuda_stream)
                else:
                    def run():
                        ops._launch_draw(lg, seeds, pos, tok, 0, size,
                                         lib=lib)
                run()
                torch.cuda.synchronize()
                same = torch.equal(tok, plain)
                if not same and name not in TIMING_ONLY:
                    raise RuntimeError(f"draw {name} | {case}: tokens "
                                       f"{tok.tolist()} differ from the "
                                       f"plain draw's {plain.tolist()}")
                ms = device_ms(run, ("draw_kernel",))
                print(f"[draw] round {rnd} | {name} | {case}: device "
                      f"{ms:.5f} ms, bitwise {same}")
                if ms < best.get(name, {}).get("device_ms", float("inf")):
                    best[name] = {"device_ms": ms, "size": size}
                if name == stamped and rnd == 1:
                    cyc = stamps(lib, run)
                    print(f"[stamps] draw {case}: cycles between phases "
                          f"(load, max, tile masses, fold + prefix sums + "
                          f"uniform, search, least hit): {cyc}")
                    best["stamps"] = cyc
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("sampler_ablations: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_lm_head import ops as head_ops
    from repro_torch.kernels.fused_lm_head import ref as head_ref
    from repro_torch.kernels.fused_sampling import ops, ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    libs = build(_build)
    print(f"[build] {len(libs)} variants in {time.perf_counter() - t0:.1f}s")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    active = _build.bind(libs[AS_BUILT][0], "filter_active_clusters", 0, 2)
    occupancy = {v: {size: active(v, size, stream) for size in range(1, 17)}
                 for v in (128256, 50304, WIDE)}
    print(f"[occupancy] clusters the card runs at once, by size: {occupancy}")
    results = {}
    for case, (lg, top_k, top_p) in filter_cases(
            dev, np.random.default_rng(0)).items():
        s, v = lg.shape
        plain = ref.filter_logits_bisect(lg, top_k, top_p)
        planned = ops.cluster_plan(s, v)
        runs = {name: (lib[0], planned) for name, lib in libs.items()}
        for size in WIDE_SIZES if v == WIDE else SIZES:
            if size != planned and ops.cluster_smem_bytes(v, size) \
                    <= ops.SMEM_BYTES:
                runs[f"{AS_BUILT}, {size} CTAs a row"] = (libs[AS_BUILT][0],
                                                          size)
        for rnd in range(2):
            for name, (lib, size) in runs.items():
                out = torch.empty_like(lg)

                def run():
                    ops._launch_filter(lg, top_k, top_p, out, size, lib=lib)
                try:
                    run()
                except RuntimeError as e:      # e.g. too little shared memory
                    print(f"[filter] round {rnd} | {name} | {case}: refused "
                          f"at {size} CTAs a row ({e})")
                    continue
                torch.cuda.synchronize()
                same = torch.equal(out.view(torch.int32),
                                   plain.view(torch.int32))
                if not same and name not in TIMING_ONLY:
                    raise RuntimeError(f"{name} | {case}: not bitwise equal "
                                       "to the plain filter")
                ms = device_ms(run, ("filter_kernel",))
                label = name + (f" ({size} CTAs a row, the plan's)"
                                if name == AS_BUILT else "")
                print(f"[filter] round {rnd} | {label} | {case}: device "
                      f"{ms:.5f} ms, bitwise {same}")
                best = results.setdefault(name, {}).get(case)
                if best is None or ms < best["device_ms"]:
                    results[name][case] = {"device_ms": ms, "size": size,
                                           "bitwise": same}
                if name == "phase stamps (timing)" and rnd == 1 \
                        and case.startswith("[1, 128256] top-k off"):
                    cyc = stamps(lib, run)
                    print(f"[stamps] {case}: cycles between phases "
                          f"(start, load, k-th, Z, four estimate passes, "
                          f"then per exact sweep: trees, barrier 1, fold, "
                          f"barrier 2; store): {cyc}")
                    results[name]["stamps_" + case] = cyc
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    heads = {}
    for arch, d, v in (("llama3.2-3b", 3072, 128256),
                       ("mamba2-1.3b", 2048, 50304),
                       ("command-r-35b", 8192, WIDE)):
        args = head_inputs(dev, d, v)
        x, w, seeds, pos, temps, top_k, top_p = args
        plain_args = (x, w, head_ref.row_uniforms(seeds, pos), temps, top_k,
                      top_p)
        planned = ops.cluster_plan(8, v)
        for rnd in range(2):
            for name, (_, lib) in libs.items():
                for sampled, filtered in ((False, False), (True, False),
                                          (True, True)):
                    tok = torch.empty((8,), dtype=torch.int32, device=dev)
                    ok = torch.empty((8,), dtype=torch.bool, device=dev)
                    size = planned if sampled else 1

                    def run():
                        head_ops._launch(x, w, seeds, pos, 0, temps, top_k,
                                         top_p, tok, ok, sampled, filtered,
                                         size, lib=lib)
                    try:
                        run()
                    except RuntimeError as e:
                        print(f"[head] round {rnd} | {name} | {arch}: refused "
                              f"at {size} CTAs a row ({e})")
                        continue
                    torch.cuda.synchronize()
                    ptok, pok = head_ref.head_tokens(*plain_args,
                                                     sampled=sampled,
                                                     filtered=filtered)
                    same = torch.equal(tok, ptok) and torch.equal(ok, pok)
                    if not same and name not in TIMING_ONLY:
                        raise RuntimeError(f"head {name} {arch}: tokens "
                                           f"{tok.tolist()} differ from "
                                           f"{ptok.tolist()}")
                    step = ("filtered" if filtered else
                            "sampled" if sampled else "greedy")
                    ms = device_ms(run, ("head_gemv_kernel",
                                         "head_epilogue_kernel"))
                    epi = device_ms(run, ("head_epilogue_kernel",))
                    print(f"[head] round {rnd} | {name} | {arch} {step}: "
                          f"device {ms:.5f} ms (epilogue {epi:.5f}), "
                          f"bitwise {same}")
                    key = f"{arch} {step}"
                    best = heads.setdefault(name, {}).get(key)
                    if best is None or ms < best["device_ms"]:
                        heads[name][key] = {"device_ms": ms,
                                            "epilogue_ms": epi,
                                            "bitwise": same}
        torch.cuda.empty_cache()
    parent = None
    if "--parent" in sys.argv:
        parent = build_parent(_build, sys.argv[sys.argv.index("--parent") + 1])
    draws = ablate_draw(libs, parent, dev)
    print(json.dumps({"card": smi, "occupancy": occupancy, "filter": results,
                      "head_tokens": heads, "draw": draws}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
