"""What the decode-shaped norm kernels' plans and loads buy, on the card.

    python3 norm_ablations.py
    python3 norm_ablations.py --compare ROOT [ROOT ...]

A development script beside ``chip_smoke.py``; no model path and no test
runs it. The first form times ``decode_residual_norm``
(``src/repro_torch/kernels/fused_layernorm/csrc/residual_norm.cu``) and
``gated_rmsnorm`` (``.../gated_rmsnorm.cu``) at the serves' shapes:
llama3.2-3b's [8, 3072] (a decode step), [64, 3072] (a prefill chunk) and
a ragged [300, 3072], rmsnorm, and [8, 3072] layernorm + bias;
mamba2-1.3b's [8, 4096], [64, 4096] and [300, 4096] with z read in place
from an in_proj row; and the widest registered rows, mistral-large's
[8, 12288] and jamba's [8, 8192]. At each
shape it runs every plan the register path takes (threads per row,
vectors a thread and 1, 2, 4 or 8 CTAs a row, a thread block cluster; the
plan ``ops.norm_plan`` picks is marked) and the wide variant forced (one
CTA of 256 threads, the row through shared memory: it stands in for the
v1 kernels' structure), through the wrappers' launch helpers
(``ops._launch_resnorm``, ``ops._launch_gated``). Variants of the source
made by text substitutions, each of which must match the source exactly
once, run at the picked plan: ``scale`` (and ``bias``) loaded only after
the row's sum instead of with the row; every division of the gate by
``__fdiv_rn``, each ending in its branch to the slow path, instead of the
branch-free in-range reciprocal. Beside them, one ``torch.add`` over the
same rows (one launch and one memory round trip; not the same function).
Every time is device time a call from torch.profiler over 40 calls, the
lesser of two rounds that each run every entry in turn; every run's output
is held to the plain version (x + y bitwise, the norm within 1 bf16 ulp of
each output, the gated norm within 1 bf16 ulp of the row's largest
|output|) and the script fails on a miss; a launch that fails is reported
and the run goes on. Last, every bf16 value of z through the gate, bitwise
against the plain version (``check_gate``, on a build that writes the
gated product as its output).

The second form runs each ROOT (the root of a checkout of this repository,
an unpacked ``git archive`` say) in a process of its own, in the order
given (parent, change, change, parent shows drift): each builds its own
kernels and times its public wrappers (``ops.decode_residual_norm``,
``ops.gated_rmsnorm``) on the same seeded inputs at the four serve shapes.

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
NAMES = {"resnorm": "resnorm_kernel", "gated": "gated_rmsnorm_kernel"}
LIBS = {"resnorm": "residual_norm", "gated": "gated_rmsnorm"}

# source variants: {name: {kernel: [(old, new), ...]}}, each old text found
# exactly once in that kernel's source
_SCALE = ("  rn::load(ss, reinterpret_cast<const uint4*>(scale), first, "
          "threads);\n")
_BIAS = ("  if (bias != nullptr)\n"
         "    rn::load(bb, reinterpret_cast<const uint4*>(bias), first, "
         "threads);\n")
_RES_OUT = "  uint4* xov = reinterpret_cast<uint4*>(xo + off);\n"
_GATED_OUT = "  uint4* ov = reinterpret_cast<uint4*>(out + row * c);\n"
VARIANTS = {
    "scale after the sum": {
        "resnorm": [(_SCALE + _BIAS, ""),
                    (_RES_OUT, _SCALE + _BIAS + _RES_OUT)],
        "gated": [(_SCALE, ""), (_GATED_OUT, _SCALE + _GATED_OUT)]},
    "the gate's divisions by __fdiv_rn (a branch each)": {
        "gated": [("s[j][e] = recip_in_range(den[j][e]);",
                   "s[j][e] = __fdiv_rn(1.f, den[j][e]);")]},
}
# the gated product itself in place of the output, for the exhaustive
# check of the gate (not timed)
GATE_ONLY = "the gated product as the output"
VARIANTS[GATE_ONLY] = {"gated": [(
    "      rn::set_bf16(o, e, __fmul_rn(__fmul_rn(rn::to_float(yy[j], e), "
    "r),\n                                   rn::to_float(ss[j], e)));\n",
    "      rn::set_bf16(o, e, rn::to_float(yy[j], e));\n")]}
AS_BUILT = "as built"

# name: (kernel, rows, width, norm kind)
CASES = {
    "decode_residual_norm [8, 3072]": ("resnorm", 8, 3072, "rmsnorm"),
    "decode_residual_norm [64, 3072]": ("resnorm", 64, 3072, "rmsnorm"),
    "decode_residual_norm [8, 3072] layernorm + bias": ("resnorm", 8, 3072,
                                                        "layernorm"),
    "decode_residual_norm [300, 3072]": ("resnorm", 300, 3072, "rmsnorm"),
    "decode_residual_norm [8, 12288]": ("resnorm", 8, 12288, "rmsnorm"),
    "gated_rmsnorm [8, 4096]": ("gated", 8, 4096, None),
    "gated_rmsnorm [64, 4096]": ("gated", 64, 4096, None),
    "gated_rmsnorm [300, 4096]": ("gated", 300, 4096, None),
    "gated_rmsnorm [8, 8192]": ("gated", 8, 8192, None),
}
COMPARE = [c for c in CASES if "12288" not in c and "8192" not in c
           and "layernorm" not in c and "300" not in c]


def variant_source(text: str, subs) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"ablation text not found once: {old!r}")
        text = text.replace(old, new)
    return text


def build(_build) -> dict:
    """Every variant's libraries, all nvcc runs at once: {variant: {kernel:
    library name under build/repro_torch/}}; "as built" is the package's
    own build."""
    _build.build_all()
    out_dir = _build.BUILD_DIR / "ablations"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = _build.sources()
    procs, libs = {}, {AS_BUILT: dict(LIBS)}
    for i, (name, per_lib) in enumerate(VARIANTS.items()):
        libs[name] = dict(LIBS)
        for kern, subs in per_lib.items():
            src = srcs[LIBS[kern]]
            lib = f"norm_ablation{i}_{LIBS[kern]}"
            path = out_dir / f"{lib}.cu"
            path.write_text(variant_source(src.read_text(), subs))
            libs[name][kern] = lib
            procs[(name, kern)] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src.parent),
                 "-o", str(_build.BUILD_DIR / f"{lib}.so"), str(path)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key!r}:\n{log}")
        regs = [ln.split("info    : ")[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {key[0]} ({key[1]}): {regs}")
    return libs


def device_ms(fn, name: str, iters: int = 40, tries: int = 3) -> float:
    """Device ms a call of the one kernel a call whose name contains
    ``name`` ("" for any kernel), from torch.profiler. A window that does
    not hold exactly ``iters`` records of it (the profiler drops records
    now and then: ablation run 5 read 0.0006 ms for a kernel that takes
    0.002) is taken again."""
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
                and name in e.key]
        if sum(e.count for e in hits) == iters:
            return sum(e.self_device_time_total for e in hits) / 1e3 / iters
    raise RuntimeError(f"the profiler did not record {iters} {name!r} "
                       "kernels in a window")


def inputs(kern, rows, d, kind, dev):
    """Seeded bf16 inputs of one case: (y, x, scale, bias) for the add +
    norm, (y, z, scale) for the gated norm, z a column slice of a
    [rows, 2 C + 320] in_proj row as mamba2's layer gives it."""
    gen = torch.Generator(device=dev).manual_seed(rows * 100003 + d)
    scale = (1 + 0.1 * torch.randn((d,), generator=gen, device=dev)
             ).bfloat16()
    y = torch.randn((rows, d), generator=gen, device=dev).bfloat16()
    if kern == "gated":
        proj = (2 * torch.randn((rows, 2 * d + 320), generator=gen,
                                device=dev)).bfloat16()
        return y, proj[:, :d], scale
    x = torch.randn((rows, d), generator=gen, device=dev).bfloat16()
    bias = (0.1 * torch.randn((d,), generator=gen, device=dev)).bfloat16() \
        if kind == "layernorm" else None
    return y, x, scale, bias


def ulp(t: torch.Tensor) -> torch.Tensor:
    mag = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def plans(d: int):
    """Every register-path plan (threads, vectors, CTAs) that covers a row
    of d exactly, then the wide variant."""
    from repro_torch.kernels.fused_layernorm import ops
    out = []
    for ctas in (1, 2, 4, 8):
        for v in ops.NORM_VECTORS:
            t, rem = divmod(d // 8, ctas * v)
            if not rem and t % 32 == 0 and 32 <= t <= ops.NORM_MAX_THREADS:
                out.append((t, v, ctas))
    return out + [ops.NORM_WIDE]


def ablate() -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_layernorm import ops, ref
    t0 = time.perf_counter()
    libs = build(_build)
    print(f"[build] {len(libs)} variants in {time.perf_counter() - t0:.1f}s")
    dev = torch.device("cuda")
    results = {}
    for case, (kern, rows, d, kind) in CASES.items():
        args = inputs(kern, rows, d, kind, dev)
        picked = ops.norm_plan(rows, d, kern == "gated")
        if kern == "gated":
            y, z, scale = args
            out = torch.empty_like(y)
            plain = ref.gated_rmsnorm(y, z, scale).float()
            tol = ulp(plain.abs().amax(-1, keepdim=True))

            def run(plan, lib):
                ops._launch_gated(y, z, scale, out, 1e-5, plan, lib=lib)

            def err():
                return ((out.float() - plain).abs() / tol).max().item(), True
            one_pass = (lambda: torch.add(y, z))
        else:
            y, x, scale, bias = args
            h, xo = torch.empty_like(x), torch.empty_like(x)
            ph, px2 = ref.decode_residual_norm(y, x, scale, bias, kind=kind)

            def run(plan, lib):
                ops._launch_resnorm(y, x, scale, bias, h, xo, kind, 1e-5,
                                    plan, lib=lib)

            def err():
                return (((h.float() - ph.float()).abs() / ulp(ph)).max()
                        .item(), torch.equal(xo, px2))
            one_pass = (lambda: torch.add(x, y))
        runs = {f"{AS_BUILT}, plan {p}" + (" (norm_plan's)" if p == picked
                                           else "")
                + (" (the wide variant)" if p == ops.NORM_WIDE else ""):
                (libs[AS_BUILT][kern], p) for p in plans(d)}
        for name, per_lib in VARIANTS.items():
            if kern in per_lib and name != GATE_ONLY:
                runs[f"{name}, plan {picked}"] = (libs[name][kern], picked)
        best = results.setdefault(case, {})
        for rnd in range(2):
            for label, (lib, plan) in runs.items():
                try:
                    run(plan, lib)
                except RuntimeError as e:
                    print(f"[ablation] round {rnd} | {case} | {label}: "
                          f"{e}")
                    best[label] = {"launch_failed": str(e)}
                    continue
                torch.cuda.synchronize()
                e, exact = err()
                if not (e <= 1.0 and exact):
                    raise SystemExit(f"norm_ablations: {case} {label}: error "
                                     f"{e} bf16 ulps, x + y bitwise {exact}")
                ms = device_ms(lambda: run(plan, lib), NAMES[kern])
                print(f"[ablation] round {rnd} | {case} | {label}: device "
                      f"{ms:.6f} ms, error {e:.3f} bf16 ulps")
                if ms < best.get(label, {}).get("device_ms", float("inf")):
                    best[label] = {"device_ms": ms, "error_ulps": e}
            ms = device_ms(one_pass, "")
            print(f"[ablation] round {rnd} | {case} | one torch.add: device "
                  f"{ms:.6f} ms")
            if "one torch.add" not in best or ms < best["one torch.add"]:
                best["one torch.add"] = ms
    results["gate, every bf16 z"] = check_gate(libs[GATE_ONLY]["gated"])
    return results


def check_gate(lib: str) -> dict:
    """Every bf16 value of z (the 65536 bit patterns as [16, 4096], NaNs
    and infinities included) through the kernel's gate (library ``lib``
    writes the gated product as its output): bitwise the plain version's
    y * (z * sigmoid(z)) in bf16 on the card (NaN where it is NaN), at y
    = 1 and at seeded y, on the picked plan (clusters of 8) and on one CTA
    of 2 vectors a thread. Exits on a mismatch."""
    from repro_torch.kernels.fused_layernorm import ops
    dev = torch.device("cuda")
    z = torch.arange(-32768, 32768, dtype=torch.int32, device=dev).to(
        torch.int16).view(torch.bfloat16).reshape(16, 4096)
    gen = torch.Generator(device=dev).manual_seed(5)
    scale = torch.ones(4096, dtype=torch.bfloat16, device=dev)
    out = {}
    for y_name, y in (("y = 1", torch.ones_like(z)),
                      ("seeded y", torch.randn((16, 4096), generator=gen,
                                               device=dev).bfloat16())):
        plain = y * (z * torch.sigmoid(z))
        for plan in (ops.norm_plan(16, 4096, True), (256, 2, 1)):
            got = torch.empty_like(y)
            ops._launch_gated(y, z, scale, got, 1e-5, plan, lib=lib)
            torch.cuda.synchronize()
            same = (got.view(torch.int16) == plain.view(torch.int16)) | (
                got.isnan() & plain.isnan())
            bad = int((~same).sum())
            out[f"{y_name}, plan {plan}"] = bad
            if bad:
                raise SystemExit(f"norm_ablations: the gate differs from "
                                 f"the plain version at {bad} of 65536 z "
                                 f"({y_name}, plan {plan})")
    print(f"[gate] every bf16 z, bitwise the plain gate: mismatches {out}")
    return out


def one(root: str) -> dict:
    """Time ``root``'s public wrappers (run in a process of its own)."""
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_layernorm import ops
    _build.build_all()
    dev = torch.device("cuda")
    out = {}
    for case in COMPARE:
        kern, rows, d, kind = CASES[case]
        args = inputs(kern, rows, d, kind, dev)
        if kern == "gated":
            fn = (lambda a=args: ops.gated_rmsnorm(*a))
        else:
            fn = (lambda a=args, k=kind: ops.decode_residual_norm(*a, kind=k))
        out[case] = min(device_ms(fn, NAMES[kern]) for _ in range(2))
    return {"root": root, "device_ms": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("norm_ablations: no CUDA device; this script runs on the card",
              file=sys.stderr)
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
