"""Serve a batch of requests with the port's static or continuous engine.

    python -m repro_torch.launch.serve --arch llama3.2-3b --device cuda
    python -m repro_torch.launch.serve --engine continuous --device cuda
    python -m repro_torch.launch.serve --arch mamba2-1.3b --smoke --device cpu
    python -m repro_torch.launch.serve --arch deepseek-moe-16b --device cuda
    python -m repro_torch.launch.serve --arch qwen2-vl-2b --engine continuous
    python -m repro_torch.launch.serve --arch whisper-base --device cuda
    python -m repro_torch.launch.serve --engine continuous --tp 2
    python -m repro_torch.launch.serve --engine continuous --tp 2 \
        --dist-backend gloo --smoke --device cpu

Counterpart of ``repro.launch.serve`` with ``--engine {static,continuous}``
(static by default, as in JAX):

static      the fixed-batch driver: one dense KV cache (or mamba state) of
            ``batch x (prompt_len + gen_len)`` rows, the whole prompt
            prefilled at once (``Model.prefill``; above ``attn_chunk`` the
            chunked attention, or the flash kernel for a config with
            ``attn_impl="flash"``), then ``gen_len - 1`` lock-step decode
            steps (``Model.decode_step``). For an encdec arch (whisper) the
            stub frontend's frame embeddings [B, enc_seq_len, D] are drawn
            on the device from ``--seed``, encoded and projected into the
            cross K/V once before the decoder's prefill; the timing line
            splits the prefill into encoder, cross K/V fill and decoder.
            ``run_static(model, args)`` takes a model built by the
            caller, so any config can be served.
continuous  ``ContinuousEngine``: paged KV cache, chunked
            prefill, prefix cache, fused decode on or off
            (``--fused-decode`` / ``--no-fused-decode``; unset follows
            ``REPRO_FUSED_DECODE``, default on). ``--decode-steps N`` runs
            up to N decode iterations per host dispatch (on the card, CUDA
            graph replays of one iteration) with the streams of N=1, and
            prints a ``decode-steps=N`` line: dispatches against decode
            steps and why the dispatches came back. ``--tp N`` serves
            with N tensor-parallel ranks, one process each, over
            ``--dist-backend`` (``nccl``, a card a rank, the default on
            the card; ``gloo``, the only backend for ``--device cpu``, or
            ranks sharing one card): the launcher spawns the ranks itself,
            or each is a process that ``torchrun --nproc-per-node N``
            started. Rank 0 prints the lines; every rank checks that its
            streams equal rank 0's.

``--sampler {fused,ref}`` picks the top-k / top-p filter of the sampler in
both engines: the kernel (the default) or the sort-based oracle; unset
follows ``REPRO_FUSED_SAMPLING``. The two give the same tokens. (Fused
decode filters in the LM head's own epilogue.)

Request i is sampled with seed ``--seed + i`` in both engines, and the draw
for stream position p uses ``fold_in(key(seed), p)``, so the two engines
emit the same tokens at any sampling setting. Weights are random, made on
the device from ``--seed`` with a ``torch.Generator``; prompts are drawn
with numpy from the same seed. Runs on the card unless ``--device cpu`` is
given. Every registered arch is served: dense (llama3.2-3b, internlm2-1.8b),
moe (deepseek-moe-16b), vlm (qwen2-vl-2b, text-only M-RoPE positions), ssm
(mamba2-1.3b) and hybrid (jamba-v0.1-52b, whose 52 B parameters need more
than one H100: ``--smoke`` on the CPU) on both engines, and encdec
(whisper-base) on the static engine only: ``--engine continuous`` is
refused for it with JAX's message. An
explicit ``--prefix-cache`` is refused for an SSM-bearing arch on
the continuous engine (its recurrent state is not page-decomposable);
without the flag the engine gates the cache off itself and the reason is
printed.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, smoke_config
from ..models.model import Model
from ..serving import ContinuousEngine, Request, SamplingParams, pages_needed
from ..serving.engine import SERVABLE_FAMILIES, prefix_cache_off_reason
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
    continuous engine does. An encdec arch's frame embeddings come from a
    ``torch.Generator`` seeded with ``seed`` on the model's device."""
    arch, dev = model.arch, model.device
    b, plen, glen = args.batch, args.prompt_len, args.gen_len
    prompt = _prompts(args, arch)
    caches = model.init_caches(b, plen + glen)
    frames = None
    if arch.family == "encdec":
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        frames = torch.randn((b, arch.enc_seq_len, arch.d_model),
                             generator=gen, device=dev).to(model.dtype)
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
    t_encode = t_cross = 0.0
    if frames is not None:
        enc = model.encode(frames)
        _sync(dev)
        t_encode = time.perf_counter() - t0
        model.fill_cross_kv(caches, enc)
        _sync(dev)
        t_cross = time.perf_counter() - t0 - t_encode
        del enc
    t1 = time.perf_counter()
    logits, caches = model.prefill(caches, torch.as_tensor(prompt,
                                                           device=dev))
    _sync(dev)
    t_decoder = time.perf_counter() - t1
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
    split = (f" (encoder {arch.enc_seq_len} frames {t_encode * 1e3:.1f}ms, "
             f"cross K/V fill {t_cross * 1e3:.1f}ms, decoder "
             f"{t_decoder * 1e3:.1f}ms)" if frames is not None else "")
    print(f"[serve/static] {arch.name} on {dev}: prefill {plen} tok x{b} "
          f"in {t_prefill * 1e3:.1f}ms{split} | {glen} decode steps in "
          f"{t_decode * 1e3:.1f}ms "
          f"({t_decode / max(glen - 1, 1) * 1e3:.1f} ms/tok)")
    print(f"[serve/static] sample generations (first 8 ids/row): "
          f"{out[:2, :8].tolist()}")
    return {"tokens": out, "prompt": prompt, "frames": frames,
            "t_prefill": t_prefill, "t_encode": t_encode,
            "t_cross_fill": t_cross, "t_decoder_prefill": t_decoder,
            "t_decode": t_decode}


def run_continuous(model: Model, args, group=None) -> dict:
    """Serve the batch through ``ContinuousEngine``; ``args`` may carry
    ``decode_steps`` (default 1), ``sampler`` and ``tp`` (default 1: one
    device; above it this process is one rank of ``group``, whose ranks
    all call this with the same arguments)."""
    arch, device = model.arch, model.device
    tp = getattr(args, "tp", 1)
    lead = group is None or torch.distributed.get_rank(group) == 0
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
        fused_decode=args.fused_decode, tp=tp, group=group)
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
    stats = {}
    if tp > 1:
        streams = [None] * tp
        torch.distributed.all_gather_object(streams, out.tolist(),
                                            group=group)
        if any(s != streams[0] for s in streams):
            raise RuntimeError(f"tp={tp}: the ranks' streams differ from "
                               "rank 0's")
        tps = stats["tp_stats"] = engine.tp_stats()
        stats["ranks_equal"] = True
    if not lead:
        return {"tokens": out, **stats}
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
    if tp > 1:
        print(f"[serve/continuous] tp={tp}: "
              f"{tps['collective_bytes_per_device'] / 1e6:.2f} MB "
              f"all-reduced per device, "
              f"{tps['per_device']['kv_bytes'] / 1e6:.2f} MB KV per device "
              f"({tps['per_device']['pages_in_use']} pages, head-sharded); "
              f"{torch.distributed.get_backend(group)}, every rank's "
              "streams equal rank 0's")
    return {"tokens": out, "wall": wall, "steps": engine.steps, **stats,
            "decode_dispatches": engine.decode_dispatches,
            "decode_exits": dict(engine.decode_exits),
            "fused_sampling": engine.fused_sampling,
            "fused_decode": engine.fused_decode,
            "fused_decode_off_reason": engine.fused_decode_off_reason,
            "prefix_cache_off_reason": engine.prefix_cache_off_reason,
            "prefills": engine.prefills,
            "prefill_tokens": engine.prefill_tokens,
            "cached_prefill_tokens": engine.cached_prefill_tokens}


def serve_jobs(group, rank, device, jobs, threads=None) -> list:
    """One rank's body (``launch.mesh.spawn``'s ``fn``) for a list of
    serving jobs, each a dict: ``arch``, ``params`` (the port's weight tree
    as numpy arrays, the same on every rank), ``requests`` and ``engine``
    (more ``ContinuousEngine`` keywords; ``tp`` and ``group`` are the
    group's). Only the rank's shards of the blocks reach ``device``.
    ``threads`` pins torch's CPU threads. Returns, a job, the streams (uid
    -> tokens), the engine's counters and ``tp_stats()``."""
    from .. import tree
    if threads:
        torch.set_num_threads(threads)
    tp = torch.distributed.get_world_size(group) if group is not None else 1
    out = []
    for job in jobs:
        model = Model(job["arch"], tree.map(torch.as_tensor, job["params"]))
        if tp > 1:
            model = model.sharded(rank, tp)
        model = Model(model.arch, tree.map(lambda t: t.to(device),
                                           model.params), model.shard)
        engine = ContinuousEngine(model, tp=tp, group=group, **job["engine"])
        res = engine.run(list(job["requests"]))
        out.append({
            "tokens": {u: r["tokens"] for u, r in res.items()},
            "counters": {k: getattr(engine, k) for k in (
                "steps", "decode_dispatches", "prefills", "prefill_chunks",
                "cow_copies", "collective_bytes", "fused_decode")},
            "tp_stats": engine.tp_stats()})
    return out


def _seeded_model(args, device, shard=None) -> Model:
    arch = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return Model.init(arch, gen, device=device, shard=shard)


def _serve_rank(group, rank, device, args) -> dict:
    """One rank of ``--tp N``: the rank's shards of the seeded model (the
    whole model's slices) on this rank's device, served by
    ``run_continuous``."""
    return run_continuous(_seeded_model(args, device, (rank, args.tp)),
                          args, group)


def run(args) -> dict:
    """Build the seeded model on ``args.device`` and serve it with
    ``args.engine``; with ``args.tp`` > 1 as that many ranks (spawned
    here, or this process one of ``torchrun``'s) -> rank 0's result."""
    tp = getattr(args, "tp", 1)
    if tp > 1:
        from . import mesh
        backend = args.dist_backend
        # nccl: a card a rank (make_tp_group picks it); gloo: every rank
        # on --device
        device = None if backend == "nccl" else str(resolve_device(
            args.device))
        if "RANK" in os.environ:            # torchrun started this rank
            group, rank, dev = mesh.make_tp_group(tp, backend=backend,
                                                  device=device)
            return _serve_rank(group, rank, dev, args)
        if resolve_device(args.device).type == "cuda":
            from ..kernels import _build
            if any(_build._stale(n) for n in _build.sources()):
                _build.build_all()  # once, before the ranks would race
        return mesh.spawn(_serve_rank, tp, args, backend=backend,
                          device=device)[0]
    device = resolve_device(args.device)
    model = _seeded_model(args, device)
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
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks, one process each "
                         "(continuous engine only; must divide the query "
                         "heads and either divide or be a multiple of the "
                         "KV heads, the latter replicating KV shards; MoE "
                         "experts shard expert-parallel)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default=None,
                    help="the ranks' torch.distributed backend at --tp > 1: "
                         "nccl (a card a rank; the default on cuda) or gloo "
                         "(the only one for --device cpu; on cuda the ranks "
                         "share one card)")
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
    if args.tp < 1:
        ap.error("--tp must be >= 1")
    if args.tp > 1 and args.engine != "continuous":
        ap.error("--tp requires --engine continuous")
    cpu = torch.device(args.device).type == "cpu"
    if args.dist_backend is None:
        args.dist_backend = "gloo" if cpu else "nccl"
    elif args.dist_backend == "nccl" and cpu:
        ap.error("--dist-backend nccl runs on cards; --device cpu takes "
                 "gloo")
    if args.fused_decode is not None and args.engine != "continuous":
        ap.error("--fused-decode requires --engine continuous (the static "
                 "driver always materializes full logits)")
    try:
        arch = smoke_config(args.arch) if args.smoke \
            else get_config(args.arch)
    except KeyError as e:
        ap.error(str(e))
    if arch.bidirectional:
        ap.error(f"{arch.name} is encoder-only: it has no decode step")
    if args.engine == "continuous" and arch.family not in SERVABLE_FAMILIES:
        ap.error(f"--engine continuous serves families "
                 f"{SERVABLE_FAMILIES}; {arch.name} is {arch.family!r} "
                 "(use --engine static)")
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
