"""What each part of the flash-attention kernel's design buys, on the card.

    python3 flash_ablations.py

A development script beside ``chip_smoke.py``; no model path and no test
runs it. Every variant is the kernel's own source
(``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``) with
parts of the design taken out by one-line text substitutions, each of which
must match the source exactly once (the script fails when the source has
moved away from them). Two groups:

- stages, cumulative in the order the design was built: wgmma and the TMA
  ring fed by a producer warpgroup, one CTA an item, masks on every tile,
  exp2f, o rescaled on every tile and the softmax waiting for p V; then
  masks on edge tiles only with ex2.approx and the rescale skipped when no
  max moved; then the persistent grid; then the softmax beside p V at D
  64 (the kernel as it is);
- ablations, one part of the kernel as it is changed: the softmax beside
  p V at D 128 too, a third ring stage, exp2f with o rescaled on every
  tile, another register split, p V without the lo product (a precision
  change: p rounded to bf16 once), and the work order KV head major
  instead of heaviest first (host side only).

All variants are built at once with ``nvcc`` into ``build/repro_torch/``
and launched through the wrapper's one launch helper
(``ops._launch``) at three shapes of ``chip_smoke.py``'s flash check: the
static prefill's q [4, 4096, 24, 128] against k/v [4, 4096, 8, 128]
causal, the ragged causal 1500, and bert-large's heads at D 64 ([2, 2048,
16, 64], kv_len [2048, 1311]). For each: the worst query row's error in
bf16 ulps of its own largest output of the fp32 plain version, and the time
by CUDA events over 20 launches, the lesser of two rounds that each run
every variant in turn. The card's name and power limit come
first; the last line is one JSON object of the results.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

_ONE_CTA_AN_ITEM = ("const int grid = p.n_items < sms[dev] ? p.n_items : "
                    "sms[dev];", "const int grid = p.n_items;")
_MASK_EVERY_TILE = ("const bool edge = c0 + BK > kvl",
                    "const bool edge = true || c0 + BK > kvl")
_EXP2F_RESCALE_ALWAYS = [
    ("alpha[hr] = exp2_ftz(", "alpha[hr] = exp2f("),
    ("x = exp2_ftz(__fsub_rn(", "x = exp2f(__fsub_rn("),
    ("x = exp2_ftz(fmaf(", "x = exp2f(fmaf("),
    ("if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f))",
     "")]
_PV_IN_FLIGHT = "constexpr int kPvInFlight = D == 64 ? 1 : 0;"
_SOFTMAX_AFTER_PV = (_PV_IN_FLIGHT, "constexpr int kPvInFlight = 0;")

# name: text substitutions (old, new) of the kernel's source
STAGES = {
    "stages 1-2: wgmma, TMA ring, producer; one CTA an item, masks on "
    "every tile, exp2f, o rescaled on every tile, softmax after p V": [
        _ONE_CTA_AN_ITEM, _MASK_EVERY_TILE, *_EXP2F_RESCALE_ALWAYS,
        _SOFTMAX_AFTER_PV],
    "stage 3: + masks on edge tiles only, ex2.approx, rescale when a max "
    "moved": [_ONE_CTA_AN_ITEM, _SOFTMAX_AFTER_PV],
    "stage 4: + persistent grid": [_SOFTMAX_AFTER_PV],
    "final: + softmax beside p V at D 64": [],
}
ABLATIONS = {
    "final, softmax beside p V at D 128 too": [
        (_PV_IN_FLIGHT, "constexpr int kPvInFlight = 1;")],
    "final, three ring stages": [("constexpr int kStages = 2;",
                                  "constexpr int kStages = 3;")],
    "final, exp2f and o rescaled on every tile": _EXP2F_RESCALE_ALWAYS,
    "final, producer 40 / consumers 232 registers": [
        ("setmaxnreg_dec<24>()", "setmaxnreg_dec<40>()"),
        ("setmaxnreg_inc<240>()", "setmaxnreg_inc<232>()")],
    "final, p V without the lo product (p rounded to bf16)": [
        ("    wgmma_rs<D>(o, pl[kk], dv);\n", "")],
}
FINAL = "final: + softmax beside p V at D 64"
KV_MAJOR = "final, KV head major work order"

# name: (B, Sq, Sk, Hq, Hkv, D, kv_len)
CASES = {
    "static prefill": (4, 4096, 4096, 24, 8, 128, None),
    "ragged causal 1500": (4, 1500, 1500, 24, 8, 128, None),
    "D 64, bert-large heads": (2, 2048, 2048, 16, 16, 64, [2048, 1311]),
}


def variant_source(text: str, subs) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"ablation text not found once: {old!r}")
        text = text.replace(old, new)
    return text


def build(_build, source) -> dict:
    """Every variant's library, all nvcc runs at once: name -> library name
    under ``build/repro_torch/``."""
    out_dir = _build.BUILD_DIR / "ablations"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = source.read_text()
    procs, libs = {}, {}
    for i, (name, subs) in enumerate({**STAGES, **ABLATIONS}.items()):
        src = out_dir / f"flash_ablation{i}.cu"
        src.write_text(variant_source(text, subs))
        libs[name] = f"flash_ablation{i}"
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(_build.BUILD_DIR / f"{libs[name]}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln]
        print(f"[build] {name}: {spills}")
    return libs


def kv_major_order(ops, b, hq, hkv, sq, sk, device) -> torch.Tensor:
    """The heaviest-first items regrouped by (batch, KV head)."""
    items = ops.work_order(b, hq, sq, sk, causal=True).tolist()
    g = hq // hkv
    rank = {c: i for i, c in enumerate(items)}
    items.sort(key=lambda c: (c % (b * hq) // g, rank[c]))
    return torch.as_tensor(np.asarray(items, np.int32), device=device)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ablations: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops, ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    libs = build(_build, _build.sources()["flash_attention"])
    print(f"[build] {len(libs)} variants in {time.perf_counter() - t0:.1f}s")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for case, (b, sq, sk, hq, hkv, d, lens) in CASES.items():
        q = torch.randn((b, sq, hq, d), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k = torch.randn((b, sk, hkv, d), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        v = torch.randn_like(k)
        kv_len = torch.tensor(lens or [sk] * b, dtype=torch.int32,
                              device=dev)
        ops._check(q, k, v, kv_len)
        plain = ref.flash_attention_fwd(
            *(t.float().transpose(1, 2) for t in (q, k, v)), kv_len,
            causal=True).transpose(1, 2)
        top = plain.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
        ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
        heaviest = ops._order_on(dev, b, hq, sq, sk, True, 0, 0)
        runs = {name: (lib, heaviest) for name, lib in libs.items()}
        runs[KV_MAJOR] = (libs[FINAL],
                          kv_major_order(ops, b, hq, hkv, sq, sk, dev))
        for rnd in range(2):
            for name, (lib, order) in runs.items():
                out = torch.empty_like(q)

                def run():
                    ops._launch(q, k, v, kv_len, order, out, causal=True,
                                q_offset=0, window=0, lib=lib)
                run()
                torch.cuda.synchronize()
                ulps = ((out.float() - plain).abs().amax(-1)
                        / ulp).max().item()
                for _ in range(2):
                    run()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    run()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / 20
                print(f"[ablation] round {rnd} | {name} | {case}: {ms:.4f} "
                      f"ms, worst row {ulps:.3f} bf16 ulps")
                best = results.setdefault(name, {}).get(case)
                if best is None or ms < best["ms"]:
                    results[name][case] = {"ms": ms, "worst_row_ulps": ulps}
        del q, k, v, plain
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "ablations": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
