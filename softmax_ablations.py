"""What the fused softmax kernel's plan and loads buy, on the card.

    python3 softmax_ablations.py
    python3 softmax_ablations.py --compare ROOT [ROOT ...]

A development script beside ``chip_smoke.py``; no model path and no test
runs it. The first form times ``scale_mask_softmax``
(``src/repro_torch/kernels/fused_softmax/csrc/scale_mask_softmax.cu``) at
``chip_smoke.py``'s eight cases (``SOFTMAX_CASES``: bert-large's Phase 1
and Phase 2 scores, ragged and offset causal rows, Sk 12288 and 32768). At
each case it runs the plan ``ops.softmax_plan`` picks (marked) and the
others the kernel takes: a warp a row at every register size that holds
the row (4, 8 or 16 elements a lane) and at 4 or 8 rows a CTA, a CTA a
row at 16 or 32 elements a thread on the fewest warps and on twice as
many, and loads of one element in place of the widest, through the wrapper's launch
helper (``ops._launch``). Variants of the source, made by text
substitutions that must each match it exactly once, run at the picked
plan: each load under its own branch (``if (c0 < nvalid)``) in place of
every load issued unconditionally (a vector with no valid column reading
column 0 again), and the row index held in 64 bits. Beside them, ``torch.softmax`` of the scores already
scaled and masked, in s's dtype (the softmax only, not the same function),
and the case's byte bound (valid entries read once, every output written
once, at 3.35 TB/s). Every time is device time a call from torch.profiler
over 20 calls, the lesser of two rounds that each run every entry in turn;
every run's output is held to the plain version as ``chip_smoke.py``
holds it (fp32 within 2^-21 of each row's largest output, bf16 within 1
bf16 ulp, masked entries exactly 0) and the script fails on a miss.

The second form runs each ROOT (the root of a checkout of this repository,
an unpacked ``git archive`` say) in a process of its own, in the order
given (parent, change, change, parent shows drift): each builds its own
kernels and times its public wrapper (``ops.scale_mask_softmax``) on the
same seeded inputs at the eight cases.

The card's name and power limit come first; the last line is one JSON
object of the results.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
LIB = "scale_mask_softmax"
KERNEL = "softmax_"          # softmax_warp_kernel, softmax_cta_kernel (and
                             # the parent's softmax_row_kernel)
AS_BUILT = "as built"
VARIANTS = {
    "each load under its own branch": [(
        "    load_vec<L>(src + (c0 < nvalid ? c0 : 0), x + k * L);\n",
        "    if (c0 < nvalid) load_vec<L>(src + c0, x + k * L);\n")],
    "the row index in 64 bits": [
        ("__device__ __forceinline__ int valid_columns(int row, int sq,",
         "__device__ __forceinline__ int valid_columns(long long row, int sq,"),
        ("  const long long last = static_cast<long long>(row % sq) + "
         "q_offset;\n", "  const long long last = row % sq + q_offset;\n")],
}
FP32_TOL = 2.0 ** -21
SCALE = 0.125


def cases() -> dict:
    sys.path.insert(0, HERE)
    import chip_smoke
    return chip_smoke.SOFTMAX_CASES


def variant_source(text: str, subs) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"ablation text not found once: {old!r}")
        text = text.replace(old, new)
    return text


def build(_build) -> dict:
    """The package's build and every variant's library, all nvcc runs at
    once: {variant: library name under build/repro_torch/}."""
    _build.build_all()
    out_dir = _build.BUILD_DIR / "ablations"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.sources()[LIB]
    procs, libs = {}, {AS_BUILT: LIB}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        lib = f"softmax_ablation{i}"
        path = out_dir / f"{lib}.cu"
        path.write_text(variant_source(src.read_text(), subs))
        libs[name] = lib
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(_build.BUILD_DIR / f"{lib}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        regs = [ln.split("info    : ")[-1].strip() for ln in log.splitlines()
                if "registers" in ln]
        print(f"[build] {name}: {regs}")
    return libs


def device_ms(fn, iters: int = 20, tries: int = 3) -> float:
    """Device ms a call of the one kernel a call whose name contains
    KERNEL, from torch.profiler; a window that does not hold exactly
    ``iters`` records of it (the profiler drops records now and then) is
    taken again."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and KERNEL in e.key]
        if sum(e.count for e in hits) == iters:
            return sum(e.self_device_time_total for e in hits) / 1e3 / iters
    raise RuntimeError(f"the profiler did not record {iters} softmax "
                       "kernels in a window")


def scores(i: int, n, sq, sk, dt, dev) -> torch.Tensor:
    """The case's seeded raw scores (std 8, q.k of unit vectors at head
    dim 64, as chip_smoke's)."""
    gen = torch.Generator(device=dev).manual_seed(1000 + i)
    return (8 * torch.randn((n, sq, sk), generator=gen, device=dev)).to(dt)


def ulp(t: torch.Tensor) -> torch.Tensor:
    mag = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def valid_entries(sq, sk, causal, off) -> int:
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, r + off + 1)) for r in range(sq))


def plans(rows: int, sk: int, dt) -> list:
    """Every plan the kernel takes for rows of sk, the picked one first."""
    from repro_torch.kernels.fused_softmax import ops
    picked = ops.softmax_plan(rows, sk, dt)
    out = [picked]
    if picked.vec > 1:
        out.append(picked._replace(vec=1))
    for per in ops.WARP_PER:
        if per >= picked.vec and 32 * per >= sk:
            for threads in (128, 256):
                out.append(ops.SoftmaxPlan(False, picked.vec, per, threads))
    for per in ops.CTA_PER:
        fewest = 32 * -(-sk // (32 * per))
        for threads in (fewest, 2 * fewest):
            if threads <= 1024:
                out.append(ops.SoftmaxPlan(True, picked.vec, per, threads))
    seen, uniq = set(), []
    for p in out:
        if p not in seen:
            seen.add(p)
            uniq.append(p)
    return uniq


def check(out, plain, causal, off, what: str) -> float:
    """chip_smoke's gate; returns the worst error over its tolerance."""
    o, p = out.float(), plain.float()
    tol = (FP32_TOL * p.amax(-1, keepdim=True) if out.dtype == torch.float32
           else ulp(p))
    worst = ((o - p).abs() / tol).max().item()
    masked_ok = True
    if causal:
        sq, sk = out.shape[-2:]
        rows = torch.arange(sq, device=out.device)[:, None] + off
        cols = torch.arange(sk, device=out.device)[None]
        masked_ok = not bool(
            (out[:, (cols > rows) & (rows >= 0)] != 0).any())
    if not (worst <= 1.0 and masked_ok):
        raise SystemExit(f"softmax_ablations: {what}: {worst} x its "
                         f"tolerance, masked entries 0: {masked_ok}")
    return worst


def ablate() -> dict:
    from repro_torch.core.roofline import H100
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_softmax import ops, ref
    t0 = time.perf_counter()
    libs = build(_build)
    print(f"[build] {len(libs)} variants in {time.perf_counter() - t0:.1f}s")
    dev = torch.device("cuda")
    results = {}
    for i, (case, (n, sq, sk, dt, causal, off)) in enumerate(cases().items()):
        s = scores(i, n, sq, sk, dt, dev)
        kw = dict(scale=SCALE, causal=causal, q_offset=off)
        plain = ref.scale_mask_softmax(s, **kw)
        y = torch.empty_like(s)
        all_plans = plans(n * sq, sk, dt)
        runs = {f"{AS_BUILT}, {p}" + (" (softmax_plan's)" if j == 0 else ""):
                (LIB, p) for j, p in enumerate(all_plans)}
        for name in VARIANTS:
            runs[f"{name}, {all_plans[0]}"] = (libs[name], all_plans[0])
        x = s.float() * SCALE
        if causal:
            pos = torch.arange(sq, device=dev)[:, None] + off
            x = torch.where(torch.arange(sk, device=dev)[None] <= pos, x,
                            ref.NEG_INF)
        x = x.to(dt)
        valid = n * valid_entries(sq, sk, causal, off)
        bound = (valid + s.numel()) * s.element_size() / H100.hbm_bw * 1e3
        best = results.setdefault(case, {"bound_ms": bound})
        for rnd in range(2):
            for label, (lib, plan) in runs.items():
                def run():
                    ops._launch(s, y, plan, lib=lib, **kw)
                try:
                    run()
                except RuntimeError as e:
                    print(f"[ablation] round {rnd} | {case} | {label}: {e}")
                    best[label] = {"launch_failed": str(e)}
                    continue
                torch.cuda.synchronize()
                worst = check(y, plain, causal, off, f"{case} {label}")
                ms = device_ms(run)
                print(f"[ablation] round {rnd} | {case} | {label}: device "
                      f"{ms:.5f} ms ({bound / ms:.3f} of the bound "
                      f"{bound:.5f}), error {worst:.3f} of tol")
                if ms < best.get(label, {}).get("device_ms", float("inf")):
                    best[label] = {"device_ms": ms, "share_of_bound":
                                   bound / ms, "err_over_tol": worst}
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    torch.softmax(x, dim=-1)
                torch.cuda.synchronize()
            ms = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     ) / 1e3 / 20
            print(f"[ablation] round {rnd} | {case} | torch.softmax of the "
                  f"scaled, masked scores: device {ms:.5f} ms")
            if ms < best.get("torch.softmax", float("inf")):
                best["torch.softmax"] = ms
        del s, plain, y, x
        torch.cuda.empty_cache()
    return results


def one(root: str) -> dict:
    """Time ``root``'s public wrapper (run in a process of its own)."""
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_softmax import ops
    _build.build_all()
    dev = torch.device("cuda")
    out = {}
    for i, (case, (n, sq, sk, dt, causal, off)) in enumerate(cases().items()):
        s = scores(i, n, sq, sk, dt, dev)
        kw = dict(scale=SCALE, causal=causal, q_offset=off)
        out[case] = min(device_ms(lambda: ops.scale_mask_softmax(s, **kw))
                        for _ in range(2))
        del s
    return {"root": root, "device_ms": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("softmax_ablations: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 2
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    if len(sys.argv) > 1 and sys.argv[1] == "--compare":
        runs = []
        for root in sys.argv[2:]:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--one", root], capture_output=True,
                                  text=True)
            if proc.returncode:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return proc.returncode
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(f"[compare] {root}: {runs[-1]['device_ms']}")
        print(json.dumps({"card": smi, "runs": runs}))
        return 0
    sys.path.insert(0, os.path.join(HERE, "src"))
    print(json.dumps({"card": smi, "ablations": ablate()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
