"""Serve a batch of requests with the port's static or continuous engine.

    python -m repro_torch.launch.serve --arch llama3.2-3b --device cuda
    python -m repro_torch.launch.serve --engine continuous --device cuda
    python -m repro_torch.launch.serve --arch mamba2-1.3b --smoke --device cpu

Counterpart of ``repro.launch.serve`` with ``--engine {static,continuous}``
(static by default, as in JAX):

static      the fixed-batch driver: one dense KV cache (or mamba state) of
            ``batch x (prompt_len + gen_len)`` rows, the whole prompt
            prefilled at once (``Model.prefill``; above ``attn_chunk`` the
            chunked attention, or the flash kernel for a config with
            ``attn_impl="flash"``), then ``gen_len - 1`` lock-step decode
            steps (``Model.decode_step``). ``run_static(model, args)`` takes
            a model built by the caller, so any config can be served.
continuous  ``ContinuousEngine`` with ``--tp 1``: paged KV cache, chunked
            prefill, prefix cache, fused decode on or off
            (``--fused-decode`` / ``--no-fused-decode``; unset follows
            ``REPRO_FUSED_DECODE``, default on). ``--decode-steps N`` runs
            up to N decode iterations per host dispatch (on the card, CUDA
            graph replays of one iteration) with the streams of N=1, and
            prints a ``decode-steps=N`` line: dispatches against decode
            steps and why the dispatches came back.

``--sampler {fused,ref}`` picks the top-k / top-p filter of the sampler in
both engines: the kernel (the default) or the sort-based oracle; unset
follows ``REPRO_FUSED_SAMPLING``. The two give the same tokens. (Fused
decode filters in the LM head's own epilogue.)

Request i is sampled with seed ``--seed + i`` in both engines, and the draw
for stream position p uses ``fold_in(key(seed), p)``, so the two engines
emit the same tokens at any sampling setting. Weights are random, made on
the device from ``--seed`` with a ``torch.Generator``; prompts are drawn
with numpy from the same seed. Runs on the card unless ``--device cpu`` is
given. An explicit ``--prefix-cache`` is refused for an SSM-bearing arch on
the continuous engine (its recurrent state is not page-decomposable);
without the flag the engine gates the cache off itself and the reason is
printed.
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
from ..serving.sampling import fused_sampling_enabled, sample_tokens


def _fused(args) -> bool:
    """``--sampler`` beats the ``REPRO_FUSED_SAMPLING`` default."""
    sampler = getattr(args, "sampler", None)
    if sampler is not None:
        return sampler == "fused"
    return fused_sampling_enabled()


def _request_seed(args, i: int) -> int:
    """Request i is seeded ``--seed + i`` (mod 2^32, the sampler's key
    width) in both engines."""
    return (args.seed + i) % 2 ** 32


def _prompts(args, arch) -> np.ndarray:
    return np.random.default_rng(args.seed).integers(
        5, arch.vocab_size, (args.batch, args.prompt_len))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_static(model: Model, args) -> dict:
    """Prefill the batch's prompts at once, then decode ``gen_len - 1``
    steps in lock-step. ``args`` needs ``batch``, ``prompt_len``,
    ``gen_len``, ``temperature``, ``top_k``, ``top_p`` and ``seed``, and
    may carry ``sampler`` (``"fused"`` / ``"ref"``: the filter; unset
    follows ``REPRO_FUSED_SAMPLING``). Greedy is a plain argmax; sampling
    folds request i's seed and the stream position into the draw, as the
    continuous engine does."""
    arch, dev = model.arch, model.device
    b, plen, glen = args.batch, args.prompt_len, args.gen_len
    prompt = _prompts(args, arch)
    caches = model.init_caches(b, plen + glen)
    if args.temperature > 0:
        filtered = args.top_k > 0 or args.top_p < 1.0
        fused = filtered and _fused(args)
        seeds = torch.as_tensor([_request_seed(args, i) for i in range(b)],
                                dtype=torch.int64, device=dev)
        temps = torch.full((b,), args.temperature, dtype=torch.float32,
                           device=dev)
        top_ks = torch.full((b,), args.top_k, dtype=torch.int32, device=dev)
        top_ps = torch.full((b,), args.top_p, dtype=torch.float32,
                            device=dev)

        def pick(logits, pos):
            positions = torch.full((b,), pos, dtype=torch.int32, device=dev)
            return sample_tokens(logits, seeds, positions, temps, top_ks,
                                 top_ps, filtered=filtered, fused=fused)
    else:
        def pick(logits, pos):
            return torch.argmax(logits, dim=-1).int()

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = model.prefill(caches, torch.as_tensor(prompt,
                                                           device=dev))
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    # the prompt's next token sits at stream position plen; decode step i
    # then emits position plen + 1 + i
    t0 = time.perf_counter()
    tok = pick(logits[:, -1], plen)
    generated = [tok]
    for i in range(glen - 1):
        logits, caches = model.decode_step(
            caches, tok[:, None],
            torch.full((b,), plen + i, dtype=torch.int64, device=dev))
        tok = pick(logits[:, -1], plen + 1 + i)
        generated.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    out = torch.stack(generated, dim=1).cpu().numpy()
    print(f"[serve/static] {arch.name} on {dev}: prefill {plen} tok x{b} "
          f"in {t_prefill * 1e3:.1f}ms | {glen} decode steps in "
          f"{t_decode * 1e3:.1f}ms "
          f"({t_decode / max(glen - 1, 1) * 1e3:.1f} ms/tok)")
    print(f"[serve/static] sample generations (first 8 ids/row): "
          f"{out[:2, :8].tolist()}")
    return {"tokens": out, "prompt": prompt, "t_prefill": t_prefill,
            "t_decode": t_decode}


def run_continuous(model: Model, args) -> dict:
    """Serve the batch through ``ContinuousEngine``; ``args`` may carry
    ``decode_steps`` (default 1) and ``sampler``."""
    arch, device = model.arch, model.device
    decode_steps = getattr(args, "decode_steps", 1)
    b, plen, glen = args.batch, args.prompt_len, args.gen_len
    prompt = _prompts(args, arch)
    max_seq = plen + glen
    num_pages = args.num_pages or (
        b * pages_needed(max_seq + 1, args.page_size) + 2)
    engine = ContinuousEngine(
        model, num_slots=args.slots or b, num_pages=num_pages,
        page_size=args.page_size, max_seq_len=max_seq + args.page_size,
        prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk or None,
        fused_sampling=_fused(args), decode_steps=decode_steps,
        fused_decode=args.fused_decode)
    reqs = [Request(uid=i, prompt=[int(t) for t in prompt[i]],
                    max_new_tokens=glen,
                    sampling=SamplingParams(
                        temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, seed=_request_seed(args, i)))
            for i in range(b)]
    t0 = time.perf_counter()
    results = engine.run(reqs)
    _sync(device)
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
    if decode_steps > 1:
        print(f"[serve/continuous] decode-steps={decode_steps}: "
              f"{engine.decode_dispatches} host dispatches for "
              f"{engine.steps} decode steps "
              f"(exits: {dict(engine.decode_exits)})")
    return {"tokens": out, "wall": wall, "steps": engine.steps,
            "decode_dispatches": engine.decode_dispatches,
            "decode_exits": dict(engine.decode_exits),
            "fused_sampling": engine.fused_sampling,
            "fused_decode": engine.fused_decode,
            "fused_decode_off_reason": engine.fused_decode_off_reason,
            "prefix_cache_off_reason": engine.prefix_cache_off_reason,
            "prefills": engine.prefills,
            "prefill_tokens": engine.prefill_tokens,
            "cached_prefill_tokens": engine.cached_prefill_tokens}


def run(args) -> dict:
    """Build the seeded model on ``args.device`` and serve it with
    ``args.engine``."""
    device = resolve_device(args.device)
    arch = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = Model.init(arch, gen, device=device)
    if args.engine == "static":
        return run_static(model, args)
    return run_continuous(model, args)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", choices=("static", "continuous"),
                    default="static")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sampler", choices=("fused", "ref"), default=None,
                    help="top-k / top-p filter: the kernel (default) or the "
                         "sort-based oracle; the same tokens either way "
                         "(default from REPRO_FUSED_SAMPLING, unset = "
                         "fused)")
    ap.add_argument("--slots", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0)
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="prefix caching (default on; refused for SSM-"
                         "bearing archs, whose engine gates it off)")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--decode-steps", type=int, default=1,
                    help="decode iterations per host dispatch: N > 1 runs "
                         "them as CUDA graph replays on the card with one "
                         "host synchronisation, the streams of N=1 "
                         "(continuous engine only)")
    ap.add_argument("--fused-decode", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="fused decode: the ln2 add + norm and the LM head "
                         "with token selection as kernels, no [S, V] logits "
                         "(default from REPRO_FUSED_DECODE, unset = on; "
                         "continuous engine only)")
    args = ap.parse_args(argv)
    try:
        sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                            top_p=args.top_p, seed=args.seed)
    except ValueError as e:
        ap.error(str(e))
    if sp.greedy and sp.filtered:
        ap.error("--top-k/--top-p have no effect at --temperature 0")
    if args.decode_steps < 1:
        ap.error("--decode-steps must be >= 1")
    if args.decode_steps > 1 and args.engine != "continuous":
        ap.error("--decode-steps requires --engine continuous (the static "
                 "engine decodes in lock-step, one token per dispatch)")
    if args.fused_decode is not None and args.engine != "continuous":
        ap.error("--fused-decode requires --engine continuous (the static "
                 "driver always materializes full logits)")
    try:
        arch = get_config(args.arch)
    except KeyError as e:
        ap.error(str(e))
    if arch.bidirectional:
        ap.error(f"{arch.name} is encoder-only: it has no decode step")
    # an explicit --prefix-cache on an SSM-bearing arch fails here with the
    # reason (the static engine has no prefix cache); unset stays True so
    # the engine gates it and records why
    if args.prefix_cache and args.engine == "continuous":
        reason = prefix_cache_off_reason(arch)
        if reason:
            ap.error(f"--prefix-cache: {reason}; rerun without "
                     "--prefix-cache")
    if args.prefix_cache is None:
        args.prefix_cache = True
    return run(args)


if __name__ == "__main__":
    main()
