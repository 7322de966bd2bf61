"""The port's continuous engine serving mamba2 against the JAX engine, on
the same converted fp32 mamba2-smoke weights (JAX ``Model.init`` through
``from_jax_params``): greedy and seeded-sampled streams (the fused and the
sort-based filter), fused decode on and off, and a starved pool with slot
recycling and forced-replay preemption (the fixture of
``tests/test_hybrid_serving.py``). Streams must be identical; a divergence
is tolerated only where the JAX top-2 logit margin at that step is below
1e-4 (a near-tie that float rounding may flip).

Also: the prefix-cache gate (engine reason and per-request stat equal to
JAX's), ``launch.serve`` refusing an explicit ``--prefix-cache`` for
mamba2, a vlm engine still refused as not ported, the weight bridge's
round trip, and the layer protocol (state kinds, launches on the CPU)."""
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
from repro_torch.kernels.fused_layernorm import ops as ln_ops
from repro_torch.kernels.fused_lm_head import ops as head_ops
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from repro_torch.models.convert import from_jax_params, to_jax_layout
from repro_torch.models.model import Model
from repro_torch.serving import ContinuousEngine, Request, SamplingParams
from repro_torch.serving.engine import prefix_cache_off_reason

torch.set_num_threads(2)

MARGIN = 1e-4
ARCH = "mamba2-1.3b"


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model) sharing one set of fp32 weights."""
    arch = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32",
                               param_dtype="float32")
    model = build_model(arch)
    params = model.init(jax.random.key(0))
    t_arch = dataclasses.replace(smoke_config(ARCH), dtype="float32")
    t_model = Model(t_arch, from_jax_params(
        t_arch, jax.tree.map(np.asarray, params), device="cpu"))
    return model, params, t_model


def _top2_margin(model, params, context):
    logits = model.forward(params, {"tokens": jnp.asarray([context])})[0]
    top = np.sort(np.asarray(logits[0, -1]))[-2:]
    return float(top[1] - top[0])


def _serve_both(pair, reqs, **kw):
    model, params, t_model = pair
    j_eng = JaxEngine(model, params, **kw)
    t_eng = ContinuousEngine(t_model, **kw)
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


@pytest.mark.parametrize("fused_decode", [False, True])
def test_greedy_streams_match_jax(pair, fused_decode):
    """Prompts of 6-40 tokens: one to three prefill chunks of 32, the last
    padded, then decode."""
    prompts = _prompts(3, 4, 6, 40)
    gens = [6, 11, 4, 9]
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=gens[i])
            for i in range(4)]
    j_eng, t_eng, j_res, t_res = _serve_both(
        pair, reqs, num_slots=4, num_pages=48, page_size=8, max_seq_len=64,
        fused_decode=fused_decode)
    _assert_same_streams(pair, reqs, j_res, t_res)
    assert t_eng.fused_decode == j_eng.fused_decode == fused_decode
    assert t_eng.live_kv_tokens == 0
    for name in ("steps", "prefills", "prefill_tokens"):
        assert getattr(t_eng, name) == getattr(j_eng, name), name


@pytest.mark.parametrize("fused_decode", [False, True])
@pytest.mark.parametrize("fused_sampling", [True, False])
def test_seeded_sampled_streams_match_jax(pair, fused_sampling,
                                          fused_decode):
    prompts = _prompts(5, 5, 8, 30)
    samplings = [SamplingParams(temperature=0.8, top_k=40, top_p=0.9, seed=7),
                 SamplingParams(temperature=1.0, seed=11),
                 SamplingParams(),
                 SamplingParams(temperature=0.7, top_p=0.8, seed=2 ** 32 - 1),
                 SamplingParams(temperature=1.3, top_k=5, seed=0)]
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=8,
                    sampling=samplings[i]) for i in range(5)]
    _, _, j_res, t_res = _serve_both(
        pair, reqs, num_slots=3, num_pages=40, page_size=8, max_seq_len=48,
        fused_sampling=fused_sampling, fused_decode=fused_decode)
    _assert_same_streams(pair, reqs, j_res, t_res)


@pytest.mark.parametrize("fused_decode", [False, True])
def test_recycling_and_forced_preemption_match_jax(pair, fused_decode):
    """2 slots and a 10-page pool for 5 requests: slots are recycled (a
    dirty mamba row is reset by the next sequence's first chunk) and
    forced-replay preemption recomputes a victim's state by re-prefilling
    its context; every sampled token must match."""
    rng = np.random.default_rng(37)
    prompts = [list(map(int, rng.integers(5, 512, 12))) for _ in range(5)]
    gens = [4, 16, 7, 12, 9]
    sps = [SamplingParams(temperature=0.8, top_k=0 if i % 2 else 20,
                          top_p=0.95, seed=1000 + i) for i in range(5)]
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=gens[i],
                    sampling=sps[i]) for i in range(5)]
    j_eng, t_eng, j_res, t_res = _serve_both(
        pair, reqs, num_slots=2, num_pages=10, page_size=4, max_seq_len=32,
        prefix_cache=False, fused_decode=fused_decode)
    _assert_same_streams(pair, reqs, j_res, t_res)
    assert t_eng.prefills > 5                  # preemption actually happened
    assert t_eng.prefills == j_eng.prefills
    assert t_eng.scheduler.allocator.used_count == 0


def test_prefix_cache_gate_and_stat_match_jax(pair):
    prompt = list(range(5, 17))
    reqs = [Request(uid=0, prompt=prompt, max_new_tokens=4),
            Request(uid=1, prompt=prompt, max_new_tokens=4)]
    j_eng, t_eng, j_res, t_res = _serve_both(
        pair, reqs, num_slots=2, num_pages=32, page_size=8, max_seq_len=64,
        prefix_cache=True)
    assert t_eng.scheduler.prefix is None
    assert t_eng.prefix_cache_off_reason == j_eng.prefix_cache_off_reason
    assert "page-decomposable" in t_eng.prefix_cache_off_reason
    assert (t_eng.has_attn, t_eng.has_ssm) == (False, True)
    for uid in (0, 1):
        assert t_res[uid]["prefix_cache"] == j_res[uid]["prefix_cache"]
        assert t_res[uid]["prefix_cache"].startswith("off: ")
        assert t_res[uid]["cached_prefill_tokens"] == 0
        assert t_res[uid]["tokens"] == j_res[uid]["tokens"]
    quiet = ContinuousEngine(pair[2], num_slots=2, num_pages=32, page_size=8,
                             max_seq_len=64, prefix_cache=False)
    assert quiet.prefix_cache_off_reason is None
    res = quiet.run([Request(uid=0, prompt=prompt, max_new_tokens=2)])
    assert "prefix_cache" not in res[0]


def test_serve_cli_rejects_explicit_prefix_cache_for_mamba2(capsys):
    cont = ["--engine", "continuous", "--smoke", "--device", "cpu"]
    with pytest.raises(SystemExit):
        serve.main(cont + ["--arch", ARCH, "--prefix-cache"])
    assert "not page-decomposable" in capsys.readouterr().err
    out = serve.main(cont + ["--arch", ARCH, "--batch", "2", "--prompt-len",
                             "20", "--gen-len", "3"])
    assert out["tokens"].shape == (2, 3)
    assert "not page-decomposable" in out["prefix_cache_off_reason"]
    assert "prefix cache off" in capsys.readouterr().out
    # a dense arch keeps an explicit --prefix-cache
    out = serve.main(cont + ["--prefix-cache", "--batch", "1",
                             "--prompt-len", "8", "--gen-len", "2"])
    assert out["prefix_cache_off_reason"] is None


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_prefix_cache_off_reason_is_one_rule(pair, family):
    """One rule, from the layer kinds, gates the cache for the engine and
    the CLI: off with a reason for any arch with a mamba layer."""
    ssm_arch = pair[2].arch
    arch = {"dense": smoke_config("llama3.2-3b"), "ssm": ssm_arch,
            "hybrid": dataclasses.replace(ssm_arch, family="hybrid",
                                          hybrid_period=2,
                                          hybrid_attn_index=1)}[family]
    reason = prefix_cache_off_reason(arch)
    if family == "dense":
        assert reason is None
        return
    assert "page-decomposable" in reason and arch.name in reason
    if family == "ssm":
        eng = ContinuousEngine(pair[2], num_slots=2, num_pages=8,
                               page_size=4)
        assert eng.prefix_cache_off_reason == reason


def test_hybrid_engine_is_still_not_ported(pair):
    """(Name kept from when it pinned the vlm refusal.) The vlm family now
    serves: ``Model.init`` builds qwen2-vl's smoke weights and the
    continuous engine serves them, as the launcher does on both engines;
    the encdec family stays static-only, as in JAX: the continuous engine
    refuses whisper with JAX's ``ValueError`` and the launcher refuses
    ``--engine continuous`` for it."""
    vlm = Model.init(smoke_config("qwen2-vl-2b"),
                     torch.Generator().manual_seed(0), device="cpu")
    res = ContinuousEngine(vlm, num_slots=2, num_pages=8, page_size=4).run(
        [Request(uid=0, prompt=list(range(5, 14)), max_new_tokens=3)])
    assert len(res[0]["tokens"]) == 3
    whisper = Model.init(smoke_config("whisper-base"),
                         torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="continuous engine serves "
                                         "families.*is 'encdec'"):
        ContinuousEngine(whisper, num_slots=2, num_pages=8, page_size=4)
    for engine in ("static", "continuous"):
        out = serve.main(["--arch", "qwen2-vl-2b", "--smoke", "--device",
                          "cpu", "--engine", engine, "--batch", "1",
                          "--prompt-len", "8", "--gen-len", "2"])
        assert out["tokens"].shape == (1, 2)
    with pytest.raises(SystemExit):
        serve.main(["--arch", "whisper-base", "--smoke", "--device", "cpu",
                    "--engine", "continuous"])


def test_weight_bridge_round_trip_for_mamba2(pair):
    _, params, t_model = pair
    want = jax.tree.map(np.asarray, params)
    got = to_jax_layout(t_model.params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    blk = t_model.params["blocks"][1]
    assert sorted(blk) == ["ln1", "mamba"]
    assert sorted(blk["mamba"]) == ["A_log", "D", "conv", "dt_bias",
                                    "in_proj", "norm_scale", "out_proj"]
    np.testing.assert_array_equal(
        blk["mamba"]["A_log"].numpy(),
        np.asarray(params["blocks"]["layer_0"]["mamba"]["A_log"])[1])


def test_serving_state_protocol_and_no_launches_on_the_cpu(pair):
    t_model = pair[2]
    arch = t_model.arch
    assert tf.period_length(arch) == 1 and tf.layer_kinds(arch) == ("mamba",)
    pools = tf.init_serving_state(arch, 16, 8, 3, torch.float32, "cpu")
    assert len(pools) == arch.num_layers
    for pool in pools:
        assert sorted(pool) == ["conv", "state"]
        assert tuple(pool["state"].shape) == (3, 16, 16, 16)
        assert tuple(pool["conv"].shape) == (3, 3, 288)
    init = Model.init(arch, torch.Generator().manual_seed(0),
                      device="cpu").params
    assert sorted(init) == ["blocks", "embed", "final_norm"]   # tied head
    assert sorted(init["blocks"][0]) == ["ln1", "mamba"]       # no ln2, MLP
    assert init["embed"]["embedding"].shape == (512, arch.d_model)
    counts = (ln_ops.LAUNCHES, head_ops.LAUNCHES)
    before = [dict(c) for c in counts]
    eng = ContinuousEngine(t_model, num_slots=2, num_pages=16, page_size=8,
                           max_seq_len=48)
    eng.run([Request(uid=0, prompt=list(range(5, 25)), max_new_tokens=3)])
    assert [dict(c) for c in counts] == before
