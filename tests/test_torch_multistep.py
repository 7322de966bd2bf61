"""The port's multi-step decode (``ContinuousEngine(decode_steps=N)``)
against its own N=1 engine and against the JAX engine at the same N, on the
same converted fp32 smoke weights, with the sanitizer on (every completion
re-checks the allocator, so a page freed twice by a dispatch's replay fails
here). Mirrors ``tests/test_multistep.py`` but for tp and the recompile
audit: streams at N in {4, 16} (dense) and 4 (ssm) equal N=1's and JAX's;
an EOS inside the loop truncates the stream; a preemption between
dispatches replays identically; the dispatch and exit counters and the step
variant keys equal JAX's. Then what the port's loop adds: iterations past an
exit are no-ops (pools and mamba state bitwise those of a loop that
stopped), on the CPU and, marked ``gpu``, with the captured graph on the
card, where JAX is absent: run that test alone with
``python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_multistep.py``."""
import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch

try:
    import jax
    from repro.configs import smoke_config as jax_smoke_config
    from repro.models import build_model
    from repro.serving import ContinuousEngine as JaxEngine
    from repro.serving import Request as JaxRequest
    from repro.serving import SamplingParams as JaxSampling
except ImportError:         # the card's machine: only the gpu test runs
    jax = None
from repro_torch.configs import smoke_config
from repro_torch.models.model import Model
from repro_torch.serving import ContinuousEngine, Request, SamplingParams

torch.set_num_threads(2)

ARCHS = {"dense": "llama3.2-3b", "ssm": "mamba2-1.3b"}
ENGINE = dict(num_slots=3, num_pages=64, page_size=4, max_seq_len=64,
              prefix_cache=False, sanitize=True)


@lru_cache(maxsize=None)
def _pair(family):
    """(JAX model, JAX params, port model) sharing one set of fp32 weights,
    built once per module."""
    from repro_torch.models.convert import from_jax_params
    arch = dataclasses.replace(jax_smoke_config(ARCHS[family]),
                               dtype="float32", param_dtype="float32")
    model = build_model(arch)
    params = model.init(jax.random.key(0))
    t_arch = dataclasses.replace(smoke_config(ARCHS[family]),
                                 dtype="float32")
    t_model = Model(t_arch, from_jax_params(
        t_arch, jax.tree.map(np.asarray, params), device="cpu"))
    return model, params, t_model


def _requests(vocab, n=4, seed=7):
    """JAX's mixed greedy / sampled / filtered traffic, ragged lengths."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        prompt = list(map(int, rng.integers(5, vocab,
                                            int(rng.integers(6, 18)))))
        sp = (SamplingParams(),
              SamplingParams(temperature=0.8, seed=100 + i),
              SamplingParams(temperature=0.9, top_k=8, top_p=0.9,
                             seed=200 + i))[i % 3]
        reqs.append(Request(uid=i, prompt=prompt,
                            max_new_tokens=int(rng.integers(4, 9)),
                            sampling=sp))
    return reqs


def _jax_requests(reqs):
    return [JaxRequest(uid=r.uid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens, eos_id=r.eos_id,
                       sampling=JaxSampling(**dataclasses.asdict(r.sampling)))
            for r in reqs]


def _serve(model, reqs, *, decode_steps, engine_cls=ContinuousEngine,
           params=None, **kw):
    opts = dict(ENGINE, **kw)
    args = (model,) if params is None else (model, params)
    engine = engine_cls(*args, decode_steps=decode_steps, **opts)
    res = engine.run(_jax_requests(reqs) if params is not None else reqs)
    return engine, {uid: r["tokens"] for uid, r in res.items()}


def _serve_jax(family, reqs, *, decode_steps, **kw):
    model, params, _ = _pair(family)
    return _serve(model, reqs, decode_steps=decode_steps,
                  engine_cls=JaxEngine, params=params, **kw)


def _variant_keys(engine):
    """A JAX engine's decode and prefill jit-cache keys, or the port's."""
    keys = engine._jit_cache if hasattr(engine, "_jit_cache") \
        else engine._traces
    return {k for k in keys if k[0] in ("decode", "prefill")}


def _need_jax():
    if jax is None:
        pytest.skip("compares with the JAX package, which is not installed")


# ------------------------------------------------------------------- parity ----

@pytest.mark.parametrize("family,fused_decode", [
    ("dense", True), ("dense", False), ("ssm", True)])
def test_multistep_streams_and_counters_match_n1_and_jax(family,
                                                         fused_decode):
    """Streams at every N equal the port's N=1 and JAX's at the same N; the
    loop amortizes (dispatches < steps); dispatches, exit reasons and the
    step variant keys equal JAX's; no variant traced twice."""
    _need_jax()
    t_model = _pair(family)[2]
    reqs = _requests(t_model.arch.vocab_size)
    e1, ref = _serve(t_model, reqs, decode_steps=1,
                     fused_decode=fused_decode)
    assert e1.decode_dispatches == e1.steps
    assert e1.decode_exits == {"eos": 0, "token_budget": 0,
                               "page_budget": 0, "horizon": 0}
    for n in ((1, 4, 16) if family == "dense" else (1, 4)):
        en, toks = _serve(t_model, reqs, decode_steps=n,
                          fused_decode=fused_decode)
        jn, jtoks = _serve_jax(family, reqs, decode_steps=n,
                               fused_decode=fused_decode)
        assert toks == ref, f"{family} diverged from N=1 at N={n}"
        assert toks == jtoks, f"{family} N={n} diverged from JAX"
        if n > 1:
            assert en.decode_dispatches < en.steps
        for name in ("steps", "decode_dispatches", "decode_exits",
                     "prefills", "prefill_tokens"):
            assert getattr(en, name) == getattr(jn, name), (n, name)
        assert _variant_keys(en) == _variant_keys(jn), n
        stats = en.trace_stats()
        assert stats["excess"] == 0 and stats["variants"] == len(en._traces)


# ------------------------------------------------------------- EOS mid-loop ----

def _eos_request(vocab, *, seed=23):
    rng = np.random.default_rng(seed)
    prompt = list(map(int, rng.integers(5, vocab, 9)))
    # sampled, not greedy: a greedy smoke stream collapses to one repeated
    # token, which never yields a usable first-occurrence EOS id
    return Request(uid=0, prompt=prompt, max_new_tokens=24,
                   sampling=SamplingParams(temperature=1.0, seed=seed))


def _first_occurrence(stream, lo, hi):
    """(token, index) of the first token in ``stream[lo:hi + 1]`` that does
    not occur earlier in the stream."""
    return next(((t, i) for i, t in enumerate(stream)
                 if lo <= i <= hi and stream.index(t) == i), (None, None))


def test_eos_mid_loop_truncates_and_frees_once():
    """An EOS on loop iteration k < N: nothing past it in the stream, one
    dispatch with the eos exit, pages freed exactly once (sanitizer on),
    and the same stream and counters as JAX's."""
    _need_jax()
    t_model = _pair("dense")[2]
    base = _eos_request(t_model.arch.vocab_size)
    _, ref = _serve(t_model, [base], decode_steps=16)
    stream = ref[0]
    # index 0 comes from the final prefill chunk, not the loop
    eos, k = _first_occurrence(stream, 2, 14)
    assert eos is not None, f"no mid-horizon token to use as EOS: {stream}"
    req = dataclasses.replace(base, eos_id=eos)
    e, toks = _serve(t_model, [req], decode_steps=16)
    assert toks[0] == stream[:k + 1]
    assert toks[0][-1] == eos and eos not in toks[0][:-1]
    assert e.decode_exits["eos"] == 1
    assert e.decode_dispatches == 1 and e.steps == k
    assert e.pages_in_use == 0
    j, jtoks = _serve_jax("dense", [req], decode_steps=16)
    assert jtoks == toks
    assert (j.steps, j.decode_dispatches, j.decode_exits) == \
        (e.steps, e.decode_dispatches, e.decode_exits)


# ----------------------------------------------- preemption between dispatches -

def _forced_preempt_engine(model, *, uid, when, **kw):
    """An engine whose scheduler force-preempts request ``uid`` once, the
    first time ``when(seq)`` holds (JAX's fixture)."""
    engine = ContinuousEngine(model, **kw)
    sched = engine.scheduler
    orig = sched.ensure_capacity
    fired = []

    def forced():
        out = orig()
        victim = next((s for s in sched.running.values()
                       if s.request.uid == uid), None)
        if not fired and victim is not None and not victim.done \
                and len(sched.running) > 1 and when(victim):
            sched._preempt(victim)
            out.append(victim)
            fired.append(victim.request.uid)
        return out

    sched.ensure_capacity = forced
    return engine, fired


def test_preemption_between_multistep_dispatches_replays_identically():
    """A forced preemption after the victim holds loop-emitted tokens
    replays to the unpreempted N=1 stream (and JAX's)."""
    _need_jax()
    t_model = _pair("dense")[2]
    reqs = [dataclasses.replace(r, max_new_tokens=max(r.max_new_tokens, 8))
            for r in _requests(t_model.arch.vocab_size, seed=29)]
    _, ref = _serve(t_model, reqs, decode_steps=1)
    engine, fired = _forced_preempt_engine(
        t_model, uid=1, when=lambda seq: len(seq.generated) >= 3,
        decode_steps=4, **ENGINE)
    res = engine.run(list(reqs))
    assert fired == [1], "forced preemption must actually fire"
    assert {uid: r["tokens"] for uid, r in res.items()} == ref
    _, jref = _serve_jax("dense", reqs, decode_steps=1)
    assert jref == ref


# -------------------------------------------------------- dispatch accounting --

def test_dispatch_accounting_and_exit_reasons_match_jax():
    """JAX's bound (dispatches per decode token under 1.1/N) and exit
    reasons, and the port's counters equal to JAX's on the same trace."""
    _need_jax()
    t_model = _pair("dense")[2]
    rng = np.random.default_rng(31)
    reqs = [Request(uid=i, prompt=list(map(int, rng.integers(
        5, t_model.arch.vocab_size, 10))), max_new_tokens=12)
        for i in range(4)]
    _, ref = _serve(t_model, reqs, decode_steps=1, num_slots=4)
    e4, toks = _serve(t_model, reqs, decode_steps=4, num_slots=4)
    assert toks == ref
    decode_tokens = sum(len(v) for v in toks.values()) - len(reqs)
    assert e4.decode_dispatches / decode_tokens < 1.1 / 4
    assert e4.decode_exits["token_budget"] >= 1
    assert e4.decode_exits["horizon"] >= 1
    assert e4.decode_exits["eos"] == 0
    j4, jtoks = _serve_jax("dense", reqs, decode_steps=4, num_slots=4)
    assert jtoks == toks
    assert (e4.steps, e4.decode_dispatches, e4.decode_exits) == \
        (j4.steps, j4.decode_dispatches, j4.decode_exits)


# ---------------------------------------------- iterations past an exit -------

def _loop_live(loop) -> bool:
    """The loop's condition read on the host (JAX's ``_cond``)."""
    c = {k: v.cpu() for k, v in loop.carry.items()}
    active = c["active"] != 0
    blocked = bool((active & (c["lens"] >= c["page_limit"])).any())
    return int(c["i"]) < loop.horizon and not bool(c["reasons"].any()) \
        and not blocked


def _loop_mode(engine, mode):
    """``force``: every dispatch runs all N iterations; ``stop``: the
    condition is read on the host before each iteration, as
    ``lax.while_loop`` checks it, and the loop stops where it is false."""
    loop = engine._loop
    if mode == "force":
        engine._loop_iterations = lambda *args: engine.decode_steps
        return
    run = loop.run

    def stopping(key, k, step, pools):
        captured = False
        for _ in range(loop.horizon):
            if not _loop_live(loop):
                break
            captured |= run(key, 1, step, pools)
        return captured
    loop.run = stopping


def _state(engine):
    """Every page but the null page 0 (the write sink of masked slots,
    which no live row reads), and every mamba state row."""
    out = []
    for p in engine.pools:
        if "k" in p:
            out += [p["k"][1:].float().cpu(), p["v"][1:].float().cpu()]
        else:
            out += [p["conv"].float().cpu(), p["state"].float().cpu()]
    return out


def _dead_iterations_case(model, n, **kw):
    """An EOS at iteration 1 of a dispatch while another slot is decoding:
    force all ``n`` iterations of every dispatch against a loop that stops;
    the streams, and the pools and state rows bit for bit, must agree."""
    vocab = model.arch.vocab_size
    other = Request(uid=0, prompt=list(range(5, 16)), max_new_tokens=3 * n)
    base = dataclasses.replace(_eos_request(vocab), uid=1)
    kw = dict(ENGINE, **kw)
    _, ref = _serve(model, [other, base], decode_steps=n, **kw)
    # uid 0 prefills and decodes first; uid 1's token 0 comes from its
    # prefill, token 2 from iteration 1 of its first dispatch
    eos, _ = _first_occurrence(ref[1], 2, 2)
    assert eos is not None, f"token 2 occurs earlier: {ref[1]}"
    reqs = [other, dataclasses.replace(base, eos_id=eos)]
    runs = {}
    for mode in ("stop", "force"):
        engine = ContinuousEngine(model, decode_steps=n, **kw)
        _loop_mode(engine, mode)
        res = engine.run(reqs)
        runs[mode] = (engine, {u: r["tokens"] for u, r in res.items()})
    (stop, s_toks), (force, f_toks) = runs["stop"], runs["force"]
    assert s_toks == f_toks
    assert s_toks[1] == ref[1][:3] and s_toks[0] == ref[0]
    assert stop.decode_exits == force.decode_exits
    assert force.decode_exits["eos"] == 1
    if model.device.type == "cuda":
        assert force._loop.replays > stop._loop.replays
        assert force.trace_stats()["excess"] == 0
    for a, b in zip(_state(stop), _state(force)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_iterations_past_an_exit_are_no_ops(family):
    _need_jax()
    _dead_iterations_case(_pair(family)[2], 16)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_captured_iterations_past_an_exit_are_no_ops_on_the_card(family):
    """The same with the captured graph on the card: bf16 weights made
    from a seed, head dim 128 (the paged kernels' width)."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA graph test: needs an NVIDIA card (sm_90a)")
    arch = smoke_config(ARCHS[family])
    if family == "dense":
        arch = dataclasses.replace(arch, head_dim=128)
    model = Model.init(arch, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    _dead_iterations_case(model, 4, page_size=16, num_pages=32)
