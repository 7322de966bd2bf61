"""The moe (deepseek-moe-16b) and hybrid (jamba-v0.1-52b) families and an
untied head (internlm2-1.8b) served by the port against the JAX package,
on the same converted fp32 smoke weights (JAX ``Model.init`` through
``from_jax_params``):

- the continuous engine at the config's ``capacity_factor`` (1.25; prompts
  of one to two 32-token chunks, so capacity binds and chunks re-bucket
  as in JAX): greedy, sampled and filtered streams, fused decode on and
  off, equal to the JAX engine's; N=4 equal to N=1;
- the static engine (``run_static``) at ``capacity_factor=8.0``, greedy,
  equal to JAX's prefill and decode steps;
- internlm2's untied head served fused: its streams equal the unfused
  engine's and JAX's fused engine's;
- the weight bridge both ways for a period-1 MoE stack and jamba's period
  of 8, the serving state's kinds, the launcher, and no kernel launch on
  the CPU.

A divergence is tolerated only where the JAX top-2 logit margin at that
step is below 1e-4 (a near-tie that float rounding may flip). Each JAX
model is built once for the module."""
import argparse
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
from repro_torch.kernels.decode_attention import ops as attn_ops
from repro_torch.kernels.fused_layernorm import ops as ln_ops
from repro_torch.kernels.fused_lm_head import ops as head_ops
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from repro_torch.models.convert import from_jax_params, to_jax_layout
from repro_torch.models.model import Model
from repro_torch.serving import ContinuousEngine, Request, SamplingParams

torch.set_num_threads(2)

MARGIN = 1e-4
MOE, HYBRID, UNTIED = "deepseek-moe-16b", "jamba-v0.1-52b", "internlm2-1.8b"
_CACHE = {}


def _with_cf(arch, cf):
    if cf is None or arch.moe is None:
        return arch
    return dataclasses.replace(arch, moe=dataclasses.replace(
        arch.moe, capacity_factor=cf))


def _pair(name, cf=None):
    """(JAX model, JAX params, port model) on one set of fp32 weights; the
    weights are made once a name, ``cf`` replaces the capacity factor."""
    if name not in _CACHE:
        arch = dataclasses.replace(jax_smoke_config(name), dtype="float32",
                                   param_dtype="float32")
        _CACHE[name] = build_model(arch).init(jax.random.key(0))
    params = _CACHE[name]
    arch = _with_cf(dataclasses.replace(jax_smoke_config(name),
                                        dtype="float32",
                                        param_dtype="float32"), cf)
    t_arch = _with_cf(dataclasses.replace(smoke_config(name),
                                          dtype="float32"), cf)
    t_model = Model(t_arch, from_jax_params(
        t_arch, jax.tree.map(np.asarray, params), device="cpu"))
    return build_model(arch), params, t_model


def _top2_margin(model, params, context):
    logits = model.forward(params, {"tokens": jnp.asarray([context])})[0]
    top = np.sort(np.asarray(logits[0, -1]))[-2:]
    return float(top[1] - top[0])


def _assert_same(pair, reqs, want, got):
    model, params, _ = pair
    for r in reqs:
        a, b = want[r.uid]["tokens"], got[r.uid]["tokens"]
        if a == b:
            continue
        step = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b)))
        margin = _top2_margin(model, params, list(r.prompt) + a[:step])
        assert margin < MARGIN, (r.uid, step, margin, a, b)


def _trace(seed=3, vocab=512):
    """Five requests, prompts of 6-56 tokens (one or two 32-token chunks),
    greedy and seeded sampled through the top-k / top-p filter (the step
    variants are few, so the JAX engine compiles few)."""
    rng = np.random.default_rng(seed)
    lens = [6, 41, 19, 56, 30]
    sps = [SamplingParams(),
           SamplingParams(temperature=0.8, top_k=40, top_p=0.9, seed=7),
           SamplingParams(temperature=1.0, top_p=0.8, seed=11),
           SamplingParams(),
           SamplingParams(temperature=1.3, top_k=5, seed=2 ** 32 - 1)]
    return [Request(uid=i, prompt=list(map(int, rng.integers(5, vocab, n))),
                    max_new_tokens=5 + i, sampling=sps[i])
            for i, n in enumerate(lens)]


KW = dict(num_slots=3, num_pages=48, page_size=8, max_seq_len=72)


def _run_jax(pair, reqs, **kw):
    model, params, _ = pair
    eng = JaxEngine(model, params, **KW, **kw)
    res = eng.run([JaxRequest(
        uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
        sampling=JaxSampling(**dataclasses.asdict(r.sampling)))
        for r in reqs])
    return eng, res


@pytest.mark.parametrize("name", [MOE, HYBRID])
def test_continuous_streams_match_jax(name):
    """The JAX engine (fused decode off) once; the port with fused decode
    off and on, each stream equal to JAX's, and the engines' counters."""
    pair = _pair(name)
    reqs = _trace()
    j_eng, want = _run_jax(pair, reqs, fused_decode=False)
    for fused in (False, True):
        eng = ContinuousEngine(pair[2], fused_decode=fused, **KW)
        assert eng.fused_decode is fused
        got = eng.run(reqs)
        _assert_same(pair, reqs, want, got)
        for attr in ("steps", "prefills", "prefill_tokens"):
            assert getattr(eng, attr) == getattr(j_eng, attr), attr
        assert eng.prefix_cache_off_reason == j_eng.prefix_cache_off_reason


@pytest.mark.parametrize("name", [MOE, HYBRID])
@pytest.mark.parametrize("fused", [False, True])
def test_multistep_streams_equal_single_step(name, fused):
    t_model = _pair(name)[2]
    reqs = _trace(seed=5)
    runs = {}
    for n in (1, 4):
        eng = ContinuousEngine(t_model, fused_decode=fused, decode_steps=n,
                               **KW)
        runs[n] = {i: r["tokens"] for i, r in eng.run(reqs).items()}
        if n > 1:
            assert eng.decode_dispatches < eng.steps
    assert runs[4] == runs[1]


@pytest.mark.parametrize("name", [MOE, HYBRID])
def test_static_matches_jax(name):
    """``run_static`` at capacity_factor 8.0 (nothing drops): 2 prompts of
    32 tokens (two SSD chunks for jamba) and 5 new tokens, greedy, against
    JAX's jitted prefill and decode steps."""
    model, params, t_model = _pair(name, cf=8.0)
    args = argparse.Namespace(batch=2, prompt_len=32, gen_len=5,
                              temperature=0.0, top_k=0, top_p=1.0, seed=4)
    got = serve.run_static(t_model, args)
    plen, b = args.prompt_len, args.batch
    caches = model.init_caches(None, b, plen + args.gen_len)
    logits, caches = jax.jit(model.prefill)(
        params, caches, {"tokens": jnp.asarray(got["prompt"])})
    decode = jax.jit(model.decode_step)
    tok = jnp.argmax(logits[:, -1], axis=-1)
    want = [tok]
    for i in range(args.gen_len - 1):
        logits, caches = decode(params, caches, {
            "tokens": tok[:, None],
            "positions": jnp.full((b,), plen + i, jnp.int32)})
        tok = jnp.argmax(logits[:, -1], axis=-1)
        want.append(tok)
    np.testing.assert_array_equal(got["tokens"],
                                  np.stack([np.asarray(t) for t in want], 1))


def test_untied_head_serves_fused_and_matches_jax():
    """internlm2's untied head: fused decode is on (no port-only reason),
    its streams equal the port's unfused engine's and JAX's fused
    engine's; the head kernel's plain version is what ran."""
    pair = _pair(UNTIED)
    assert not pair[2].arch.tie_embeddings
    reqs = _trace(seed=9)
    j_eng, want = _run_jax(pair, reqs, fused_decode=True)
    assert j_eng.fused_decode
    got = {}
    for fused in (False, True):
        eng = ContinuousEngine(pair[2], fused_decode=fused, **KW)
        assert eng.fused_decode is fused
        assert eng.fused_decode_off_reason is None
        got[fused] = eng.run(reqs)
        _assert_same(pair, reqs, want, got[fused])
    for r in reqs:
        assert got[True][r.uid]["tokens"] == got[False][r.uid]["tokens"]


@pytest.mark.parametrize("name", [MOE, HYBRID])
def test_weight_bridge_round_trip(name):
    """Period 1 (deepseek: ``blocks.layer_0`` stacked over 2 layers) and
    jamba's one period of 8 (``blocks.period_0.layer_<i>``): the port's
    tree goes back to JAX's leaf for leaf, layers in order."""
    _, params, t_model = _pair(name)
    want = jax.tree.map(np.asarray, params)
    got = to_jax_layout(t_model.params, tf.period_length(t_model.arch))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)


def test_serving_state_kinds_and_init():
    """jamba-smoke: one period of 8 layers, attention at index 4, MoE on
    the odd layers; deepseek-smoke: every layer MoE with 2 shared experts;
    the port's own init has the JAX tree's names and shapes, and serving
    launches no kernel on the CPU."""
    jamba = smoke_config(HYBRID)
    assert tf.period_length(jamba) == 8 and jamba.num_layers == 8
    assert tf.layer_kinds(jamba) == ("mamba",) * 4 + ("attn",) + \
        ("mamba",) * 3
    pools = tf.init_serving_state(jamba, 16, 8, 3, torch.float32, "cpu")
    assert [sorted(p) for p in pools] == [["conv", "state"]] * 4 + \
        [["k", "v"]] + [["conv", "state"]] * 3
    for name in (HYBRID, MOE):
        arch = smoke_config(name)
        p = Model.init(arch, torch.Generator().manual_seed(0),
                       device="cpu").params
        want = to_jax_layout(_pair(name)[2].params, tf.period_length(arch))
        got = to_jax_layout(p, tf.period_length(arch))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.shape == w.shape
        for i, blk in enumerate(p["blocks"]):
            assert ("moe" in blk) == arch.is_moe_layer(i)
            assert ("mlp" in blk) != ("moe" in blk)
    arch = smoke_config(MOE)
    assert sorted(p["blocks"][0]["moe"]) == ["experts", "router", "shared"]
    assert p["blocks"][0]["moe"]["experts"]["w2"].shape == (4, 256, 128)
    assert p["out"]["head"].shape == (128, 512)
    counts = (attn_ops.LAUNCHES, ln_ops.LAUNCHES, head_ops.LAUNCHES)
    before = [dict(c) for c in counts]
    ContinuousEngine(Model(arch, p), **KW).run(_trace()[:2])
    assert [dict(c) for c in counts] == before


def test_paged_kernels_get_contiguous_queries_without_rope(monkeypatch):
    """jamba has no positional encoding, so its q stays a column view of
    the fused QKV projection; the paged layers must hand the kernels (which
    refuse a non-contiguous q on the card) a contiguous one."""
    from repro_torch.kernels.decode_attention import ops as pd_ops
    seen = []
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        def checked(q, *args, _f=getattr(pd_ops, name), **kw):
            seen.append(q.is_contiguous())
            return _f(q, *args, **kw)
        monkeypatch.setattr(pd_ops, name, checked)
    t_model = _pair(HYBRID)[2]
    assert t_model.arch.pos_emb == "none"
    ContinuousEngine(t_model, **KW).run(_trace()[:2])
    assert seen and all(seen)


@pytest.mark.parametrize("name", [MOE, HYBRID, UNTIED])
@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_serve_cli_serves_the_new_archs(capsys, name, engine):
    out = serve.main(["--arch", name, "--smoke", "--device", "cpu",
                      "--engine", engine, "--batch", "2", "--prompt-len",
                      "16", "--gen-len", "3"])
    assert out["tokens"].shape == (2, 3)
    if engine == "continuous":
        assert out["fused_decode"] and out["fused_decode_off_reason"] is None
        assert "fused decode on" in capsys.readouterr().out
