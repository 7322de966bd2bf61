"""The registry's last three architectures against the JAX package:

- the port's ``REGISTRY`` holds JAX's 11 archs with every field JAX's
  ``ArchConfig`` shares with it equal (the MoE and SSD payloads too), the
  same ``param_count`` (total and active), and JAX's ``ASSIGNED`` list in
  JAX's order;
- command-r-35b (dense, LayerNorm with its bias, RoPE theta 8e6, tied),
  mistral-large-123b (dense, untied head) and llama4-maverick-400b-a17b
  (MoE on every other layer from layer 1: top-1 of 4 experts at smoke
  size, one shared expert) served on JAX's converted fp32 smoke weights
  (every bias perturbed by seeded numpy noise, since JAX initialises them
  to zero): the continuous engine's greedy, sampled and filtered streams
  with fused decode off and on, each equal to the JAX engine's, and
  ``run_static`` greedy equal to JAX's jitted prefill and decode steps;
- the weight bridge both ways (JAX -> port -> JAX leaf for leaf; the
  port's own init in JAX's tree shapes);
- the plain filter and draw at command-r's 256,000-entry rows, bitwise
  JAX's streaming filter (``ops._filter_logits_jnp``, its path off the
  TPU) and JAX's ``draw_tokens`` (smoke vocabularies are 512, so this is
  the only place the CPU sees a row that wide).

A stream divergence is tolerated only where the JAX top-2 logit margin at
that step is below 1e-4 (a near-tie that float rounding may flip). Each
JAX model is built once for the module."""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.fused_lm_head import ref as jhead
from repro.kernels.fused_sampling import ops as jsops
from repro.models import build_model
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro_torch import configs
from repro_torch.configs import smoke_config
from repro_torch.kernels.fused_lm_head import ref as head
from repro_torch.kernels.fused_sampling import ops as sops
from repro_torch.kernels.fused_sampling import ref as sref
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from repro_torch.models.convert import from_jax_params, to_jax_layout
from repro_torch.models.model import Model
from repro_torch.serving import ContinuousEngine, Request, SamplingParams

torch.set_num_threads(2)

MARGIN = 1e-4
NEW = ("command-r-35b", "mistral-large-123b", "llama4-maverick-400b-a17b")
PORT_LACKS = {"scan_layers"}    # JAX's lax.scan switch: no port counterpart
BIASES = ("bias", "bqkv", "bq", "bk", "bv", "bo", "b1", "b2", "b3")
_CACHE = {}


def _pair(name):
    """(JAX model, JAX params as numpy, port model) in fp32, every bias of
    the JAX init perturbed by 0.1 N(0, 1) from a seeded numpy generator."""
    if name not in _CACHE:
        arch = dataclasses.replace(jax_smoke_config(name), dtype="float32",
                                   param_dtype="float32")
        model = build_model(arch)
        params = jax.tree.map(np.asarray, model.init(jax.random.key(0)))
        rng = np.random.default_rng(1)

        def perturb(path, leaf):
            if str(getattr(path[-1], "key", "")) in BIASES:
                return (leaf + 0.1 * rng.normal(size=leaf.shape)
                        ).astype(np.float32)
            return leaf
        params = jax.tree_util.tree_map_with_path(perturb, params)
        t_arch = dataclasses.replace(smoke_config(name), dtype="float32")
        _CACHE[name] = (model, params, Model(t_arch, from_jax_params(
            t_arch, params, device="cpu")))
    return _CACHE[name]


# ------------------------------------------------------------- registry ---
def test_registry_keys_and_assigned_match_jax():
    assert list(configs.REGISTRY) == list(jax_configs.REGISTRY)
    assert configs.ASSIGNED == jax_configs.ASSIGNED
    assert len(configs.ASSIGNED) == 10
    assert "bert-large" in configs.REGISTRY
    assert "bert-large" not in configs.ASSIGNED


@pytest.mark.parametrize("name", list(jax_configs.REGISTRY))
def test_arch_fields_and_param_count_match_jax(name):
    want, got = jax_configs.get_config(name), configs.get_config(name)
    fields = {f.name for f in dataclasses.fields(want)}
    assert fields - {f.name for f in dataclasses.fields(got)} == PORT_LACKS
    for f in sorted(fields - PORT_LACKS):
        a, b = getattr(want, f), getattr(got, f)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f
        else:
            assert a == b, f
    assert got.param_count() == want.param_count()
    assert got.param_count(active_only=True) == \
        want.param_count(active_only=True)


def test_new_archs_are_what_the_configs_say():
    cr = configs.get_config("command-r-35b")
    assert cr.param_count() == 30_283_530_240
    assert cr.norm == "layernorm" and cr.tie_embeddings
    assert not configs.get_config("mistral-large-123b").tie_embeddings
    l4 = configs.get_config("llama4-maverick-400b-a17b")
    moe = l4.moe
    assert (moe.num_experts, moe.top_k, moe.num_shared_experts,
            moe.expert_ff, moe.every, moe.first) == (128, 1, 1, 8192, 2, 1)
    assert [l4.is_moe_layer(i) for i in range(4)] == [False, True] * 2
    assert tf.period_length(l4) == 2
    smoke = smoke_config("llama4-maverick-400b-a17b")
    assert smoke.num_layers == 2 and smoke.moe.top_k == 1
    assert [smoke.is_moe_layer(i) for i in range(2)] == [False, True]


# -------------------------------------------------------- smoke serving ---
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
    """Four requests, prompts of 6-41 tokens (one or two 32-token chunks),
    greedy, sampled at temperature only, and seeded sampled through the
    top-k / top-p filter."""
    rng = np.random.default_rng(seed)
    lens = [6, 41, 19, 30]
    sps = [SamplingParams(),
           SamplingParams(temperature=0.8, top_k=40, top_p=0.9, seed=7),
           SamplingParams(temperature=1.0, seed=11),
           SamplingParams(temperature=1.3, top_k=5, seed=2 ** 32 - 1)]
    return [Request(uid=i, prompt=list(map(int, rng.integers(5, vocab, n))),
                    max_new_tokens=4 + i, sampling=sps[i])
            for i, n in enumerate(lens)]


KW = dict(num_slots=3, num_pages=48, page_size=8, max_seq_len=72)


@pytest.mark.parametrize("name", NEW)
def test_continuous_streams_match_jax(name):
    """The JAX engine (fused decode off, bitwise its fused decode by JAX's
    own contract) once; the port with fused decode off and on, each stream
    equal to JAX's, and the engines' counters."""
    pair = _pair(name)
    model, params, t_model = pair
    reqs = _trace()
    j_eng = JaxEngine(model, params, fused_decode=False, **KW)
    want = j_eng.run([JaxRequest(
        uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
        sampling=JaxSampling(**dataclasses.asdict(r.sampling)))
        for r in reqs])
    for fused in (False, True):
        eng = ContinuousEngine(t_model, fused_decode=fused, **KW)
        assert eng.fused_decode is fused
        assert eng.fused_decode_off_reason is None
        got = eng.run(reqs)
        _assert_same(pair, reqs, want, got)
        for attr in ("steps", "prefills", "prefill_tokens"):
            assert getattr(eng, attr) == getattr(j_eng, attr), attr


@pytest.mark.parametrize("name", NEW)
def test_static_matches_jax(name):
    """``run_static``: 2 prompts of 24 tokens and 4 new tokens, greedy,
    against JAX's jitted prefill and decode steps (llama4's top-1 routing
    at the config's capacity factor, as both engines run it)."""
    model, params, t_model = _pair(name)
    args = argparse.Namespace(batch=2, prompt_len=24, gen_len=4,
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


@pytest.mark.parametrize("name", NEW)
def test_weight_bridge_both_ways(name):
    """JAX's tree -> the port's layers -> JAX's tree, leaf for leaf
    (llama4's stack is one scanned period of a dense and a MoE layer); the
    port's own init has JAX's names and shapes, a MoE only where
    ``is_moe_layer`` says, and (command-r) a LayerNorm bias beside each
    scale."""
    _, params, t_model = _pair(name)
    arch = t_model.arch
    period = tf.period_length(arch)
    got = to_jax_layout(t_model.params, period)
    assert jax.tree.structure(got) == jax.tree.structure(params)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_array_equal(g, w)
    own = Model.init(smoke_config(name), torch.Generator().manual_seed(0),
                     device="cpu").params
    mine = to_jax_layout(own, period)
    assert jax.tree.structure(mine) == jax.tree.structure(params)
    for g, w in zip(jax.tree.leaves(mine), jax.tree.leaves(params)):
        assert g.shape == w.shape
    for i, blk in enumerate(own["blocks"]):
        assert ("moe" in blk) == arch.is_moe_layer(i)
        assert sorted(blk["ln1"]) == (["bias", "scale"]
                                      if arch.norm == "layernorm"
                                      else ["scale"])
    assert ("head" in own.get("out", {})) != arch.tie_embeddings


@pytest.mark.parametrize("name", NEW)
def test_serve_cli_serves_the_new_archs(name):
    out = serve.main(["--arch", name, "--smoke", "--device", "cpu",
                      "--engine", "continuous", "--batch", "2",
                      "--prompt-len", "16", "--gen-len", "3"])
    assert out["tokens"].shape == (2, 3)
    assert out["fused_decode"] and out["fused_decode_off_reason"] is None


# ------------------------------------------------- 256,000-entry rows ---
def test_plain_filter_and_draw_match_jax_at_256000():
    """Two rows of 256,000 logits (command-r's vocabulary): the port's
    bisection filter (and the CPU wrapper, which runs it) bitwise JAX's
    streaming filter, and the port's draw of the filtered rows bitwise
    JAX's draw on the same uniforms."""
    v = configs.get_config("command-r-35b").vocab_size
    rng = np.random.default_rng(28)
    lg = (rng.normal(size=(2, v)) * 3.0).astype(np.float32)
    lg[1, 1000:1040] = lg[1, 1040]              # ties at the k-th value
    top_k = np.array([0, 40], np.int32)
    top_p = np.array([0.95, 0.9], np.float32)
    want = np.asarray(jsops._filter_logits_jnp(
        jnp.asarray(lg), jnp.asarray(top_k), jnp.asarray(top_p)))
    t_args = (torch.from_numpy(lg), torch.from_numpy(top_k),
              torch.from_numpy(top_p))
    got = sref.filter_logits_bisect(*t_args).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    wrapped = sops.filter_logits(*t_args).numpy()
    np.testing.assert_array_equal(wrapped.view(np.int32),
                                  want.view(np.int32))
    assert np.isfinite(got[0]).sum() > 1000 and 1 < np.isfinite(got[1]).sum() <= 80
    seeds = np.array([3, 2 ** 32 - 1], np.uint32)
    positions = np.array([17, 4095], np.int32)
    rs = head.row_uniforms(torch.from_numpy(seeds.astype(np.int64)),
                           torch.from_numpy(positions))
    j_rs = np.asarray(jhead.row_uniforms(jnp.asarray(seeds),
                                         jnp.asarray(positions)))
    np.testing.assert_array_equal(rs.numpy().view(np.uint32),
                                  j_rs.view(np.uint32))
    for lg_f in (got, lg):
        tok = head.draw_tokens(torch.from_numpy(lg_f), rs).numpy()
        j_tok = np.asarray(jhead.draw_tokens(jnp.asarray(lg_f),
                                             jnp.asarray(j_rs)))
        np.testing.assert_array_equal(tok, j_tok)
