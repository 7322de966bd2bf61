"""What the paged attention kernels' split, ring and boxes buy, on the card.

    python3 paged_ablations.py

A development script beside ``chip_smoke.py``; no model path and no test
runs it. Every variant is the kernels' own source
(``src/repro_torch/kernels/decode_attention/csrc/paged_attention.cu``) with
one part of the design changed by text substitutions, each of which must
match the source exactly once (the script fails when the source has moved
away from them): the ring 4 stages deep in decode, 16 in both; 8 decode
warps (each taking every eighth tile) instead of 4; 8 prefill warps (two a
group of 16 rows, taking alternate tiles, their states folded) instead of
4 (one a group, walking every tile); boxes of 8 key rows where pages of 16
allow one box a tile; the page ids fetched only once the length is known;
no prefetch of the tensor maps; the loads alone (the products skipped) and
the products alone (no load issued: smem as it is), both for timing only,
their outputs garbage; p V without the lo product (a precision change: p
rounded to bf16 once). The kernel as it is also runs at every split of a
sweep: the split is a launch argument, the host plan's choice marked.

All variants are built at once with ``nvcc`` into ``build/repro_torch/``
and launched through the wrapper's launch helpers (``ops._launch_decode``,
``ops._launch_prefill``) at llama3.2-3b's heads (24 / 8, D 128, page 16),
in ``chip_smoke.py``'s shapes: decode over 8 slots of 128-576 tokens,
decode over 2 slots of 4096 and 1500 tokens and of 8192 and 1500 tokens
(how the time grows with the longest row), the prefill chunk of 64 rows
at 448 of 498; and decode over 8 slots of 16 tokens (one tile a row: the
kernel's fixed cost). Decode rotates 4 pool sets so K/V come from HBM. For
each: the worst row's error in bf16 ulps of its own largest output of the
fp32 plain version, and the device time a call from torch.profiler over 40
calls, the lesser of two rounds that each run every variant in turn. The
card's name and power limit come first; the last line is one JSON object
of the results.
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

_STAGES = "static constexpr int kStages = kDecode ? 8 : 4;"
_WARPS = "static constexpr int kWarps = 4;"

# name: text substitutions (old, new) of the kernels' source
VARIANTS = {
    "as built": [],
    "decode ring 4": [(_STAGES, "static constexpr int kStages = "
                                "kDecode ? 4 : 4;")],
    "ring 16": [(_STAGES, "static constexpr int kStages = 16;")],
    "decode 8 warps": [
        (_WARPS, "static constexpr int kWarps = kDecode ? 8 : 4;")],
    "prefill 8 warps, two a row group": [
        (_WARPS, "static constexpr int kWarps = kDecode ? 4 : 8;"),
        (_STAGES, "static constexpr int kStages = 8;")],
    "boxes of 8 rows": [("return page_size % KT == 0 ? KT : kMinBox;",
                         "return kMinBox;")],
    "page ids fetched after the length": [("pid[j] = i < fetch && ",
                                           "pid[j] = i < n_local && ")],
    "no tensor-map prefetch": [
        ('      asm volatile("prefetch.tensormap [%0];\\n" ::"l"(\n'
         '          reinterpret_cast<uint64_t>(&tk)) : "memory");\n', ""),
        ('      asm volatile("prefetch.tensormap [%0];\\n" ::"l"(\n'
         '          reinterpret_cast<uint64_t>(&tv)) : "memory");\n', "")],
    # the two halves of the work apart (timing only: outputs are garbage)
    "loads only (no products)": [
        ("      mbar_wait(full + 8 * s, (i / L::kStages) & 1);\n",
         "      mbar_wait(full + 8 * s, (i / L::kStages) & 1);\n"
         "      if (p.g > 0) {\n"
         "        __syncwarp();\n"
         "        if (lane == 0) mbar_arrive(empty + 8 * s);\n"
         "        continue;\n"
         "      }\n")],
    "products only (no loads)": [
        ("          mbar_expect_tx(full + 8 * s, kStageBytes);\n",
         "          mbar_arrive(full + 8 * s);\n"),
        ("            if (j >= boxes) break;\n",
         "            if (j >= boxes || p.g > 0) break;\n")],
    "p V without the lo product": [
        ("        mma(o[2 * n2], pl, vb[0], vb[1]);\n", ""),
        ("        mma(o[2 * n2 + 1], pl, vb[2], vb[3]);\n", "")],
}
AS_BUILT = "as built"
SPLITS = [1, 2, 3, 4, 5, 6, 7, 8]

# name: decode lengths, or ("prefill", chunk, start, valid)
CASES = {
    "decode 8 x 128-576": None,            # chip_smoke.py's draw, below
    "decode 2 x [4096, 1500]": [4096, 1500],
    "decode 2 x [8192, 1500]": [8192, 1500],
    "decode 8 x 16 (one tile a row)": [16] * 8,
    "prefill 64 rows at 448 of 498": ("prefill", 64, 448, 50),
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
    for i, (name, subs) in enumerate(VARIANTS.items()):
        src = out_dir / f"paged_ablation{i}.cu"
        src.write_text(variant_source(text, subs))
        libs[name] = f"paged_ablation{i}"
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(_build.BUILD_DIR / f"{libs[name]}.so"), str(src)],
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
    """Device ms a call of the kernels named ``name``, from torch.profiler
    (a window in which the profiler delivered no kernel record, as happens
    now and then, is taken again)."""
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
                 and name in e.key)
        if us > 0:
            return us / 1e3 / iters
    raise RuntimeError(f"the profiler recorded no {name} time: "
                       f"{[e.key for e in prof.key_averages()]}")


def decode_inputs(dev, gen, lens, hq=24, hkv=8, d=128, page=16):
    b = len(lens)
    max_pages = max(36, -(-max(lens) // page))
    num_pages = b * max_pages + 1
    sets = [(torch.randn((num_pages, page, hkv, d), generator=gen,
                         device=dev, dtype=torch.bfloat16),
             torch.randn((num_pages, page, hkv, d), generator=gen,
                         device=dev, dtype=torch.bfloat16))
            for _ in range(4)]
    ids = np.random.default_rng(1).permutation(np.arange(1, num_pages))
    pt = torch.as_tensor(ids[:b * max_pages].reshape(b, max_pages)
                         .astype(np.int32), device=dev)
    sl = torch.as_tensor(np.asarray(lens, np.int32), device=dev)
    q = torch.randn((b, hq, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    return q, sets, pt, sl


def prefill_inputs(dev, gen, c, start, valid, hq=24, hkv=8, d=128, page=16):
    max_pages, num_pages = 35, 64
    kp = torch.randn((num_pages, page, hkv, d), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    vp = torch.randn_like(kp)
    row = np.random.default_rng(2).permutation(np.arange(1, num_pages))
    pr = torch.as_tensor(row[:max_pages].astype(np.int32), device=dev)
    q = torch.randn((c, hq, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    return q, kp, vp, pr, start, start + valid


def row_ulps(out, plain) -> float:
    top = plain.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return ((out.float() - plain).abs().amax(-1) / ulp).max().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_ablations: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops, ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    libs = build(_build, _build.sources()["paged_attention"])
    print(f"[build] {len(libs)} variants in {time.perf_counter() - t0:.1f}s")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    lens = np.asarray(np.random.default_rng(0).integers(128, 577, 8))
    lens[0], lens[1] = 576, 17         # as chip_smoke.py draws them
    results = {}
    for case, spec in CASES.items():
        prefill = isinstance(spec, tuple)
        if prefill:
            q, kp, vp, pr, start, total = prefill_inputs(dev, gen, *spec[1:])
            plain = ref.paged_prefill_attention(q.float(), kp.float(),
                                                vp.float(), pr, start, total)
            planned = ops.prefill_plan(q.shape[0], q.shape[1], kp.shape[2],
                                       start, total, kp.shape[1],
                                       pr.shape[0])[0]
        else:
            q, sets, pt, sl = decode_inputs(dev, gen,
                                            list(spec or lens.tolist()))
            plain = ref.paged_decode_attention(
                q.float(), sets[0][0].float(), sets[0][1].float(), pt, sl)
            planned = ops.decode_plan(q.shape[0], sets[0][0].shape[2],
                                      pt.shape[1], sets[0][0].shape[1])
        runs = {name: (lib, planned) for name, lib in libs.items()}
        for split in SPLITS:
            if split != planned:
                runs[f"{AS_BUILT}, split {split}"] = (libs[AS_BUILT], split)
        for rnd in range(2):
            for name, (lib, split) in runs.items():
                out = torch.empty_like(q)
                state = {"i": 0}

                def run():
                    if prefill:
                        ops._launch_prefill(q, kp, vp, pr, start, total, out,
                                            split, lib=lib)
                    else:
                        k, v = sets[state["i"] % 4]
                        state["i"] += 1
                        ops._launch_decode(q, k, v, pt, sl, out, split,
                                           lib=lib)
                state["i"] = 0
                run()
                torch.cuda.synchronize()
                ulps = row_ulps(out, plain)
                ms = device_ms(run, "prefill_kernel" if prefill
                               else "decode_kernel")
                label = name + (f" (split {split}, the plan's)"
                                if lib == libs[AS_BUILT] and name == AS_BUILT
                                else "")
                print(f"[ablation] round {rnd} | {label} | {case}: device "
                      f"{ms:.5f} ms, worst row {ulps:.4f} bf16 ulps")
                best = results.setdefault(name, {}).get(case)
                if best is None or ms < best["device_ms"]:
                    results[name][case] = {"device_ms": ms, "split": split,
                                           "worst_row_ulps": ulps}
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "ablations": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
