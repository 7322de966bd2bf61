"""The vlm family (qwen2-vl-2b: M-RoPE, biases on every projection) served
by the port against the JAX package, on the same converted fp32 smoke
weights (JAX ``Model.init``, every bias perturbed with seeded numpy noise,
since JAX initialises them to zero and a dropped bias would not show):

- ``apply_mrope`` against JAX's with distinct t, h and w streams (1e-6 of
  the largest |x|), each stream's dims and equal streams bitwise the
  port's ``apply_rope``;
- the forward with ``mrope_positions`` (1e-4), and the static engine's
  ``prefill`` / ``decode_step`` with them;
- the continuous engine: greedy, sampled and filtered streams, fused decode
  off and on, equal to the JAX engine's; N=4 equal to N=1;
- the static engine (``run_static``) equal to JAX's prefill and decode
  steps;
- the weight bridge both ways, the port's own init, the launcher on both
  engines, no kernel launch on the CPU;
- ``accumulate_microbatches`` splits ``mrope_positions`` [3, B, S] along
  its batch axis.

A divergence is tolerated only where the JAX top-2 logit margin at that
step is below 1e-4. The JAX model is built once for the module."""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro.models import layers as jlayers
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro_torch import tree
from repro_torch.configs import smoke_config
from repro_torch.kernels.decode_attention import ops as attn_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.fused_layernorm import ops as ln_ops
from repro_torch.kernels.fused_lm_head import ops as head_ops
from repro_torch.kernels.fused_sampling import ops as samp_ops
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.models.convert import from_jax_params, to_jax_layout
from repro_torch.models.model import Model
from repro_torch.optim.grad import accumulate_microbatches
from repro_torch.serving import ContinuousEngine, Request, SamplingParams

torch.set_num_threads(2)

VLM = "qwen2-vl-2b"
MARGIN = 1e-4
BIASES = ("bias", "bqkv", "bq", "bk", "bv", "bo", "b1", "b2", "b3")
_CACHE = {}


def perturbed_pair(name):
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


@pytest.fixture(scope="module")
def pair():
    return perturbed_pair(VLM)


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


def _trace(seed=3):
    """Five requests, prompts of 6-56 tokens (one or two 32-token chunks),
    greedy, sampled and filtered."""
    rng = np.random.default_rng(seed)
    lens = [6, 41, 19, 56, 30]
    sps = [SamplingParams(),
           SamplingParams(temperature=0.8, top_k=40, top_p=0.9, seed=7),
           SamplingParams(temperature=1.0, top_p=0.8, seed=11),
           SamplingParams(),
           SamplingParams(temperature=1.3, seed=2 ** 32 - 1)]
    return [Request(uid=i, prompt=list(map(int, rng.integers(5, 512, n))),
                    max_new_tokens=5 + i, sampling=sps[i])
            for i, n in enumerate(lens)]


KW = dict(num_slots=3, num_pages=48, page_size=8, max_seq_len=72)


@pytest.mark.parametrize("shape,theta", [((2, 40, 4, 128), 1e6),
                                         ((1, 7, 3, 32), 1e4)])
def test_apply_mrope_matches_jax_and_reduces_to_rope(shape, theta):
    """Distinct t, h and w streams: within 1e-6 of the largest |x| of
    JAX's jitted ``apply_mrope`` (the floor of the two libraries' pow, sin
    and cos: the port's plain RoPE is as far from JAX's, also checked);
    each stream's frequency dims bitwise the port's ``apply_rope`` with
    that stream's positions; equal streams bitwise ``apply_rope``."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    b, s, _, d = shape
    pos = np.stack([rng.integers(0, 50, (b, s)) for _ in range(3)])
    tol = 1e-6 * float(np.abs(x).max())
    want = jax.jit(jlayers.apply_mrope, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(pos), theta)
    xt, pt = torch.as_tensor(x), torch.as_tensor(pos)
    got = layers.apply_mrope(xt, pt, theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)
    rope_j = jax.jit(jlayers.apply_rope, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(pos[1]), theta)
    np.testing.assert_allclose(layers.apply_rope(xt, pt[1], theta).numpy(),
                               np.asarray(rope_j), rtol=0, atol=tol)
    half = d // 2
    bounds = [0, half // 2, half // 2 + half // 4, half]
    for i in range(3):
        rope = layers.apply_rope(xt, pt[i], theta)
        for lo in (0, half):
            cols = slice(lo + bounds[i], lo + bounds[i + 1])
            assert torch.equal(got[..., cols], rope[..., cols]), (i, lo)
    text = pt[0]
    same = layers.apply_mrope(xt, text[None].expand(3, b, s), theta)
    assert torch.equal(same, layers.apply_rope(xt, text, theta))


def test_forward_with_mrope_positions_matches_jax(pair):
    model, params, t_model = pair
    rng = np.random.default_rng(2)
    toks = rng.integers(5, 512, (2, 24))
    mp = rng.integers(0, 40, (3, 2, 24))
    want = jax.jit(model.forward)(params, {
        "tokens": jnp.asarray(toks), "mrope_positions": jnp.asarray(mp)})[0]
    got = model_lib.forward(t_model.arch, t_model.params, {
        "tokens": torch.as_tensor(toks),
        "mrope_positions": torch.as_tensor(mp)})[0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
    # the biases reach the output: zeroing them moves the logits
    zeroed = {**t_model.params, "blocks": [
        {k: ({n: (torch.zeros_like(t) if n in BIASES else t)
              for n, t in v.items()} if isinstance(v, dict) else v)
         for k, v in blk.items()} for blk in t_model.params["blocks"]]}
    moved = model_lib.forward(t_model.arch, zeroed, {
        "tokens": torch.as_tensor(toks),
        "mrope_positions": torch.as_tensor(mp)})[0]
    assert (moved - got).abs().max() > 1e-2


def test_static_steps_with_mrope_positions_match_jax(pair):
    """``Model.prefill`` and ``decode_step`` with explicit [3, B, S]
    positions against JAX's, logits within 1e-4."""
    model, params, t_model = pair
    rng = np.random.default_rng(4)
    b, s = 2, 20
    toks = rng.integers(5, 512, (b, s))
    mp = rng.integers(0, 30, (3, b, s))
    jc = model.init_caches(None, b, s + 2)
    jl, jc = jax.jit(model.prefill)(params, jc, {
        "tokens": jnp.asarray(toks), "mrope_positions": jnp.asarray(mp)})
    tc = t_model.init_caches(b, s + 2)
    tl, tc = t_model.prefill(tc, torch.as_tensor(toks),
                             mrope_positions=torch.as_tensor(mp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    dp = rng.integers(0, 30, (3, b, 1))
    jl, _ = jax.jit(model.decode_step)(params, jc, {
        "tokens": jnp.asarray(nxt), "positions": jnp.full((b,), s, jnp.int32),
        "mrope_positions": jnp.asarray(dp)})
    tl, _ = t_model.decode_step(tc, torch.as_tensor(np.array(nxt)),
                                torch.full((b,), s, dtype=torch.int64),
                                mrope_positions=torch.as_tensor(dp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


def test_continuous_streams_match_jax(pair):
    """The JAX engine (fused decode off) once; the port with fused decode
    off and on, each stream equal to JAX's, and the engines' counters."""
    reqs = _trace()
    model, params, t_model = pair
    j_eng = JaxEngine(model, params, fused_decode=False, **KW)
    want = j_eng.run([JaxRequest(
        uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
        sampling=JaxSampling(**dataclasses.asdict(r.sampling)))
        for r in reqs])
    for fused in (False, True):
        eng = ContinuousEngine(t_model, fused_decode=fused, **KW)
        assert eng.fused_decode is fused
        got = eng.run(reqs)
        _assert_same(pair, reqs, want, got)
        for attr in ("steps", "prefills", "prefill_tokens",
                     "cached_prefill_tokens"):
            assert getattr(eng, attr) == getattr(j_eng, attr), attr


@pytest.mark.parametrize("fused", [False, True])
def test_multistep_streams_equal_single_step(pair, fused):
    reqs = _trace(seed=5)
    runs = {}
    for n in (1, 4):
        eng = ContinuousEngine(pair[2], fused_decode=fused, decode_steps=n,
                               **KW)
        runs[n] = {i: r["tokens"] for i, r in eng.run(reqs).items()}
        if n > 1:
            assert eng.decode_dispatches < eng.steps
    assert runs[4] == runs[1]


def test_static_matches_jax(pair):
    """``run_static``: 2 prompts of 40 tokens, 5 new, greedy, against
    JAX's jitted prefill and decode steps."""
    model, params, t_model = pair
    args = argparse.Namespace(batch=2, prompt_len=40, gen_len=5,
                              temperature=0.0, top_k=0, top_p=1.0, seed=4)
    got = serve.run_static(t_model, args)
    assert got["frames"] is None
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


def test_weight_bridge_and_init(pair):
    """The port's tree goes back to JAX's leaf for leaf; the port's own
    init has the same names and shapes (biases on qkv, o and the three
    SwiGLU projections, as JAX's global ``use_bias``)."""
    _, params, t_model = pair
    got = to_jax_layout(t_model.params)
    assert jax.tree.structure(got) == jax.tree.structure(params)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_array_equal(g, w)
    arch = smoke_config(VLM)
    p = Model.init(arch, torch.Generator().manual_seed(0), device="cpu")
    own = to_jax_layout(p.params)
    assert jax.tree.structure(own) == jax.tree.structure(params)
    for g, w in zip(jax.tree.leaves(own), jax.tree.leaves(params)):
        assert g.shape == w.shape
    blk = p.params["blocks"][0]
    assert sorted(blk["attn"]) == ["bo", "bqkv", "wo", "wqkv"]
    assert sorted(blk["mlp"]) == ["b1", "b2", "b3", "w1", "w2", "w3"]


def test_no_kernel_launch_on_the_cpu(pair):
    counts = (attn_ops.LAUNCHES, ln_ops.LAUNCHES, head_ops.LAUNCHES,
              samp_ops.LAUNCHES, flash_ops.LAUNCHES)
    before = [dict(c) for c in counts]
    ContinuousEngine(pair[2], **KW).run(_trace()[:2])
    flash = Model(dataclasses.replace(pair[2].arch, attn_impl="flash"),
                  pair[2].params)
    serve.run_static(flash, argparse.Namespace(
        batch=1, prompt_len=80, gen_len=2, temperature=0.8, top_k=5,
        top_p=0.9, seed=0))
    assert [dict(c) for c in counts] == before


@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_serve_cli_serves_qwen2_vl(capsys, engine):
    out = serve.main(["--arch", VLM, "--smoke", "--device", "cpu",
                      "--engine", engine, "--batch", "2", "--prompt-len",
                      "16", "--gen-len", "3"])
    assert out["tokens"].shape == (2, 3)
    if engine == "continuous":
        assert out["fused_decode"] and out["fused_decode_off_reason"] is None
        assert "fused decode on" in capsys.readouterr().out


def test_accumulate_microbatches_splits_mrope_positions_on_the_batch_axis(
        pair):
    """Two micro-batches of a [4, 12] batch: each sees ``mrope_positions``
    [3, 2, 12], the three streams of its own rows, and the averaged
    gradients equal those of the whole batch."""
    t_model = pair[2]
    arch = t_model.arch
    rng = np.random.default_rng(6)
    batch = {"mrope_positions": torch.as_tensor(rng.integers(0, 20,
                                                             (3, 4, 12))),
             "tokens": torch.as_tensor(rng.integers(5, 512, (4, 12))),
             "targets": torch.as_tensor(rng.integers(5, 512, (4, 12)))}
    params = {"embed": t_model.params["embed"],
              "blocks": t_model.params["blocks"],
              "final_norm": t_model.params["final_norm"]}
    params = tree.map(lambda t: t.clone().requires_grad_(True), params)
    seen = []

    def loss_fn(p, mb):
        seen.append(mb["mrope_positions"])
        return model_lib.loss(arch, p, mb)
    whole, _ = accumulate_microbatches(loss_fn, params, batch, 1)
    split, _ = accumulate_microbatches(loss_fn, params, batch, 2)
    assert [tuple(t.shape) for t in seen] == [(3, 4, 12), (3, 2, 12),
                                              (3, 2, 12)]
    assert torch.equal(seen[1], batch["mrope_positions"][:, :2])
    assert torch.equal(seen[2], batch["mrope_positions"][:, 2:])
    for a, b in zip(tree.leaves(whole), tree.leaves(split)):
        torch.testing.assert_close(a.float(), b, rtol=1e-4, atol=1e-6)
