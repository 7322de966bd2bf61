"""Serve a batch of requests with the port's continuous engine.

    python -m repro_torch.launch.serve --arch llama3.2-3b --device cuda
    python -m repro_torch.launch.serve --arch mamba2-1.3b --smoke --device cpu

Counterpart of ``repro.launch.serve`` with ``--engine continuous
--decode-steps 1 --tp 1``, fused decode on or off (``--fused-decode`` /
``--no-fused-decode``; unset follows ``REPRO_FUSED_DECODE``, default on).
Weights are random, made on the device from ``--seed`` with a
``torch.Generator``; prompts are drawn with numpy from the same seed.
Request i is sampled with seed ``--seed + i``. Runs on the card unless
``--device cpu`` is given. An explicit ``--prefix-cache`` is refused for an
SSM-bearing arch (its recurrent state is not page-decomposable); without
the flag the engine gates the cache off itself and the reason is printed.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, smoke_config
from ..models.model import Model
from ..serving import ContinuousEngine, Request, SamplingParams, pages_needed
from ..serving.engine import prefix_cache_off_reason


def run(args) -> dict:
    device = resolve_device(args.device)
    arch = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = Model.init(arch, gen, device=device)
    b, plen, glen = args.batch, args.prompt_len, args.gen_len
    prompt = np.random.default_rng(args.seed).integers(
        5, arch.vocab_size, (b, plen))
    max_seq = plen + glen
    num_pages = args.num_pages or (
        b * pages_needed(max_seq + 1, args.page_size) + 2)
    engine = ContinuousEngine(
        model, num_slots=args.slots or b, num_pages=num_pages,
        page_size=args.page_size, max_seq_len=max_seq + args.page_size,
        prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk or None,
        fused_decode=args.fused_decode)
    reqs = [Request(uid=i, prompt=[int(t) for t in prompt[i]],
                    max_new_tokens=glen,
                    sampling=SamplingParams(
                        temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, seed=(args.seed + i) % 2 ** 32))
            for i in range(b)]
    t0 = time.perf_counter()
    results = engine.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    out = np.stack([np.asarray(results[i]["tokens"]) for i in range(b)])
    print(f"[serve/continuous] {arch.name} on {device}: {b} requests x "
          f"{glen} tokens in {wall * 1e3:.1f}ms ({out.size / wall:.1f} tok/s, "
          f"{engine.steps} decode steps, {engine.prefills} prefills, "
          f"{engine.prefill_tokens} prompt tokens computed / "
          f"{engine.cached_prefill_tokens} from prefix cache)")
    print(f"[serve/continuous] sample generations (first 8 ids/row): "
          f"{out[:2, :8].tolist()}")
    print(f"[serve/continuous] fused decode "
          f"{'on' if engine.fused_decode else 'off'}"
          + (f": {engine.fused_decode_off_reason}"
             if engine.fused_decode_off_reason else ""))
    if engine.prefix_cache_off_reason:
        print(f"[serve/continuous] prefix cache off: "
              f"{engine.prefix_cache_off_reason}")
    return {"tokens": out, "wall": wall, "steps": engine.steps,
            "fused_decode": engine.fused_decode,
            "fused_decode_off_reason": engine.fused_decode_off_reason,
            "prefix_cache_off_reason": engine.prefix_cache_off_reason,
            "prefills": engine.prefills,
            "prefill_tokens": engine.prefill_tokens,
            "cached_prefill_tokens": engine.cached_prefill_tokens}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0)
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="prefix caching (default on; refused for SSM-"
                         "bearing archs, whose engine gates it off)")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--fused-decode", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="fused decode: the ln2 add + norm and the LM head "
                         "with token selection as kernels, no [S, V] logits "
                         "(default from REPRO_FUSED_DECODE, unset = on)")
    args = ap.parse_args(argv)
    try:
        sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                            top_p=args.top_p, seed=args.seed)
    except ValueError as e:
        ap.error(str(e))
    if sp.greedy and sp.filtered:
        ap.error("--top-k/--top-p have no effect at --temperature 0")
    # an explicit --prefix-cache on an SSM-bearing arch fails here with the
    # reason; unset stays True so the engine gates it and records why
    if args.prefix_cache:
        try:
            reason = prefix_cache_off_reason(get_config(args.arch))
        except KeyError as e:
            ap.error(str(e))
        if reason:
            ap.error(f"--prefix-cache: {reason}; rerun without "
                     "--prefix-cache")
    if args.prefix_cache is None:
        args.prefix_cache = True
    return run(args)


if __name__ == "__main__":
    main()
