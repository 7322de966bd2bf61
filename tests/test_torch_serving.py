"""The port's continuous engine against the JAX engine, both with
fused_decode=False (the fused path is held in test_torch_fused_decode.py),
on the same converted fp32 smoke weights: greedy and seeded-sampled token
streams, a shared-prefix trace with copy-on-write, forced preemption, the
overlong-request error result and EOS. Streams must be identical; a
divergence is tolerated only where the JAX top-2 logit margin at that
step is below 1e-4 (a near-tie that float rounding may flip)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro_torch.configs import smoke_config
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import Model
from repro_torch.serving import ContinuousEngine, Request, SamplingParams

torch.set_num_threads(2)

MARGIN = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model) sharing one set of fp32 weights."""
    arch = dataclasses.replace(jax_smoke_config("llama3.2-3b"),
                               dtype="float32", param_dtype="float32")
    model = build_model(arch)
    params = model.init(jax.random.key(0))
    t_arch = dataclasses.replace(smoke_config("llama3.2-3b"),
                                 dtype="float32")
    t_model = Model(t_arch, from_jax_params(
        t_arch, jax.tree.map(np.asarray, params), device="cpu"))
    return model, params, t_model


def _top2_margin(model, params, context):
    logits = model.forward(params, {"tokens": jnp.asarray([context])})[0]
    top = np.sort(np.asarray(logits[0, -1]))[-2:]
    return float(top[1] - top[0])


def _serve_both(pair, reqs, **kw):
    model, params, t_model = pair
    j_eng = JaxEngine(model, params, fused_decode=False, **kw)
    t_eng = ContinuousEngine(t_model, fused_decode=False, **kw)
    j_res = j_eng.run([JaxRequest(
        uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
        eos_id=r.eos_id, sampling=JaxSampling(**dataclasses.asdict(r.sampling)))
        for r in reqs])
    t_res = t_eng.run(reqs)
    return j_eng, t_eng, j_res, t_res


def _assert_same_streams(pair, reqs, j_res, t_res):
    model, params, _ = pair
    for r in reqs:
        a, b = j_res[r.uid]["tokens"], t_res[r.uid]["tokens"]
        if a == b:
            continue
        step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y) \
            if any(x != y for x, y in zip(a, b)) else min(len(a), len(b))
        margin = _top2_margin(model, params, list(r.prompt) + a[:step])
        print(f"request {r.uid} diverged at step {step}: JAX top-2 logit "
              f"margin {margin:.3e}")
        assert margin < MARGIN, (r.uid, step, margin, a, b)


def _prompts(seed, n, lo, hi, vocab=512):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(5, vocab, rng.integers(lo, hi))))
            for _ in range(n)]


def test_greedy_streams_match_jax(pair):
    prompts = _prompts(3, 4, 6, 14)
    gens = [6, 11, 4, 9]
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=gens[i])
            for i in range(4)]
    j_eng, t_eng, j_res, t_res = _serve_both(
        pair, reqs, num_slots=4, num_pages=48, page_size=8, max_seq_len=64)
    _assert_same_streams(pair, reqs, j_res, t_res)
    assert t_eng.live_kv_tokens == 0
    assert (t_eng.steps, t_eng.prefills) == (j_eng.steps, j_eng.prefills)


@pytest.mark.parametrize("fused_sampling", [True, False])
def test_seeded_sampled_streams_match_jax(pair, fused_sampling):
    prompts = _prompts(5, 5, 8, 20)
    samplings = [SamplingParams(temperature=0.8, top_k=40, top_p=0.9, seed=7),
                 SamplingParams(temperature=1.0, seed=11),
                 SamplingParams(),
                 SamplingParams(temperature=0.7, top_p=0.8, seed=2 ** 32 - 1),
                 SamplingParams(temperature=1.3, top_k=5, seed=0)]
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=8,
                    sampling=samplings[i]) for i in range(5)]
    _, _, j_res, t_res = _serve_both(
        pair, reqs, num_slots=3, num_pages=40, page_size=8, max_seq_len=48,
        fused_sampling=fused_sampling)
    _assert_same_streams(pair, reqs, j_res, t_res)


def test_shared_prefix_cow_trace_matches_jax(pair):
    rng = np.random.default_rng(21)
    prefix = list(map(int, rng.integers(5, 512, 19)))    # 2 pages + 3
    reqs = [Request(uid=i, prompt=prefix + list(map(
        int, rng.integers(5, 512, 4))), max_new_tokens=5 + i,
        sampling=SamplingParams(temperature=0.9, top_k=20, seed=i)
        if i % 2 else SamplingParams()) for i in range(4)]
    j_eng, t_eng, j_res, t_res = _serve_both(
        pair, reqs, num_slots=4, num_pages=48, page_size=8, max_seq_len=64,
        prefix_cache=True)
    _assert_same_streams(pair, reqs, j_res, t_res)
    assert t_eng.cow_copies == 3
    for name in ("cow_copies", "prefills", "prefill_tokens",
                 "cached_prefill_tokens", "steps"):
        assert getattr(t_eng, name) == getattr(j_eng, name), name
    for r in reqs:
        assert t_res[r.uid]["cached_prefill_tokens"] == \
            j_res[r.uid]["cached_prefill_tokens"]


def test_forced_preemption_matches_jax(pair):
    """The preemption fixture of the JAX tests: 2 slots and a 10-page pool
    for 5 requests, so recycling and forced-replay preemption both run."""
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(5, 512, 12))) for _ in range(5)]
    gens = [4, 16, 7, 12, 9]
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=gens[i],
                    sampling=SamplingParams(temperature=0.8, top_p=0.9,
                                            seed=i) if i in (1, 3)
                    else SamplingParams()) for i in range(5)]
    j_eng, t_eng, j_res, t_res = _serve_both(
        pair, reqs, num_slots=2, num_pages=10, page_size=4, max_seq_len=32,
        prefix_cache=False)
    _assert_same_streams(pair, reqs, j_res, t_res)
    assert t_eng.prefills > 5                  # preemption actually happened
    assert t_eng.prefills == j_eng.prefills
    assert t_eng.scheduler.allocator.used_count == 0


def test_overlong_request_error_and_eos_match_jax(pair):
    prompts = _prompts(11, 2, 10, 11)
    reqs = [Request(uid=0, prompt=prompts[0], max_new_tokens=5),
            Request(uid=1, prompt=list(range(5, 45)), max_new_tokens=5),
            Request(uid=2, prompt=prompts[1], max_new_tokens=7)]
    _, _, j_res, t_res = _serve_both(
        pair, reqs, num_slots=2, num_pages=32, page_size=8, max_seq_len=32)
    assert "error" in t_res[1] and t_res[1]["tokens"] == []
    _assert_same_streams(pair, [reqs[0], reqs[2]], j_res, t_res)
    eos = t_res[2]["tokens"][2]
    stop = t_res[2]["tokens"].index(eos) + 1
    _, t_eng, _, eos_res = _serve_both(
        pair, [Request(uid=0, prompt=prompts[1], max_new_tokens=7,
                       eos_id=eos)],
        num_slots=2, num_pages=32, page_size=8, max_seq_len=32)
    assert eos_res[0]["tokens"] == t_res[2]["tokens"][:stop]
    assert t_eng.live_kv_tokens == 0


@pytest.mark.parametrize("kw", [{"tp": 2}, {"tp": 2, "decode_steps": 4},
                                {"tp": 2, "sanitize": True}])
def test_unported_engine_options_raise(pair, kw):
    """Tensor parallelism is not ported, whatever the other options (the
    multi-step loop and the sanitizer are: test_torch_multistep.py and
    test_torch_sanitize.py)."""
    with pytest.raises(NotImplementedError, match="not ported"):
        ContinuousEngine(pair[2], num_slots=2, num_pages=8, page_size=4, **kw)


def test_engine_constructs_with_fused_decode_on(pair):
    eng = ContinuousEngine(pair[2], num_slots=2, num_pages=8, page_size=4,
                           fused_decode=True)
    assert eng.fused_decode and eng.fused_decode_off_reason is None
