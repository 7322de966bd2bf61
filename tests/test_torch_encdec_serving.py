"""The encdec family (whisper-base: a bidirectional encoder over the stub
frontend's frame embeddings, decoder blocks with cross-attention to it)
served by the port's static engine against the JAX package, on the same
converted fp32 smoke weights (JAX ``Model.init``, every bias perturbed with
seeded numpy noise, since JAX initialises them to zero):

- the forward with ``frontend_embeddings`` (1e-4);
- the static engine with 80 frames (above the smoke's ``attn_chunk`` 64,
  so the encoder and the prefill's cross-attention take the chunked path,
  or the flash kernel's plain version): prefill logits within 1e-4, the
  caches, cross K/V included, within 1e-5, and ``run_static``'s greedy and
  sampled streams equal to JAX's prefill / decode steps on the same frame
  embeddings;
- the continuous engine's and the launcher's refusals, with JAX's text;
- the weight bridge both ways and the port's own init;
- ``param_count``, ``transformer_gemms`` and ``nongemm_ops`` equal to
  JAX's for both new full configs;
- no kernel launch on the CPU.

A divergence is tolerated only where the JAX top-2 logit margin at that
step is below 1e-4. The JAX model is built once for the module."""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core import analytical as janalytical
from repro.models import build_model
from repro.serving.sampling import sample_tokens as jax_sample_tokens
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import analytical
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.fused_sampling import ops as samp_ops
from repro_torch.launch import serve
from repro_torch.models import model as model_lib
from repro_torch.models.convert import (caches_from_jax, from_jax_params,
                                        to_jax_layout)
from repro_torch.models.model import Model
from repro_torch.serving import ContinuousEngine

torch.set_num_threads(2)

ENCDEC = "whisper-base"
FRAMES = 80                 # above the smoke's attn_chunk (64)
MARGIN = 1e-4
BIASES = ("bias", "bqkv", "bq", "bk", "bv", "bo", "b1", "b2", "b3")


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params as numpy, port model), fp32, 80 frames, every
    bias (layernorm biases too) perturbed by 0.1 N(0, 1)."""
    arch = dataclasses.replace(jax_smoke_config(ENCDEC), dtype="float32",
                               param_dtype="float32", enc_seq_len=FRAMES)
    model = build_model(arch)
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0)))
    rng = np.random.default_rng(1)

    def perturb(path, leaf):
        if str(getattr(path[-1], "key", "")) in BIASES:
            return (leaf + 0.1 * rng.normal(size=leaf.shape)
                    ).astype(np.float32)
        return leaf
    params = jax.tree_util.tree_map_with_path(perturb, params)
    t_arch = dataclasses.replace(smoke_config(ENCDEC), dtype="float32",
                                 enc_seq_len=FRAMES)
    return model, params, Model(t_arch, from_jax_params(t_arch, params,
                                                        device="cpu"))


def _with_impl(model, impl):
    return Model(dataclasses.replace(model.arch, attn_impl=impl),
                 model.params)


def test_forward_with_frontend_embeddings_matches_jax(pair):
    model, params, t_model = pair
    rng = np.random.default_rng(2)
    toks = rng.integers(5, 512, (2, 12))
    frames = rng.normal(size=(2, FRAMES, 128)).astype(np.float32)
    want = jax.jit(model.forward)(params, {
        "tokens": jnp.asarray(toks),
        "frontend_embeddings": jnp.asarray(frames)})[0]
    got = model_lib.forward(t_model.arch, t_model.params, {
        "tokens": torch.as_tensor(toks),
        "frontend_embeddings": torch.as_tensor(frames)})[0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)


def _jax_stream(pair, got, args):
    """JAX's jitted prefill and decode steps on ``run_static``'s prompt and
    frame embeddings, tokens picked as ``run_static`` picks them; returns
    the tokens, the prefill's last logits and caches."""
    model, params, _ = pair
    b, plen = args.batch, args.prompt_len
    caches = model.init_caches(None, b, plen + args.gen_len)
    logits, caches = jax.jit(model.prefill)(params, caches, {
        "tokens": jnp.asarray(got["prompt"]),
        "frontend_embeddings": jnp.asarray(got["frames"].numpy())})
    first = (np.asarray(logits), jax.tree.map(np.asarray, caches))
    seeds = jnp.asarray([args.seed + i for i in range(b)], jnp.uint32)

    def pick(lg, pos):
        if args.temperature == 0:
            return jnp.argmax(lg, axis=-1)
        return jax_sample_tokens(
            lg, seeds, jnp.full((b,), pos, jnp.int32),
            jnp.full((b,), args.temperature, jnp.float32),
            jnp.full((b,), args.top_k, jnp.int32),
            jnp.full((b,), args.top_p, jnp.float32), filtered=True,
            fused=False)
    decode = jax.jit(model.decode_step)
    tok = pick(logits[:, -1], plen)
    out = [tok]
    for i in range(args.gen_len - 1):
        logits, caches = decode(params, caches, {
            "tokens": tok[:, None],
            "positions": jnp.full((b,), plen + i, jnp.int32)})
        tok = pick(logits[:, -1], plen + 1 + i)
        out.append(tok)
    return np.stack([np.asarray(t) for t in out], 1), first


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_static_matches_jax(pair, temperature):
    """``run_static`` with attn_impl chunked (encoder and prefill
    cross-attention over 80 frames above attn_chunk 64), then flash (its
    plain version; JAX's runs its chunked path on the CPU): greedy, or
    sampled through top-k 5 / top-p 0.9, streams equal to JAX's; prefill
    logits within 1e-4 and caches, cross K/V included, within 1e-5."""
    args = argparse.Namespace(batch=2, prompt_len=24, gen_len=5,
                              temperature=temperature,
                              top_k=5 if temperature else 0,
                              top_p=0.9 if temperature else 1.0, seed=3)
    for impl in ("chunked", "flash"):
        t_model = _with_impl(pair[2], impl)
        before = dict(flash_ops.LAUNCHES)
        got = serve.run_static(t_model, args)
        assert dict(flash_ops.LAUNCHES) == before
        assert tuple(got["frames"].shape) == (2, FRAMES, 128)
        assert got["t_encode"] > 0 and got["t_cross_fill"] > 0
        if impl == "chunked":
            want, (j_logits, j_caches) = _jax_stream(pair, got, args)
            # the port's own prefill on the same inputs, caches too
            caches = t_model.init_caches(2, args.prompt_len + args.gen_len)
            logits, caches = t_model.prefill(
                caches, torch.as_tensor(got["prompt"]), got["frames"])
            np.testing.assert_allclose(logits.numpy(), j_logits, atol=1e-4)
            want_caches = caches_from_jax(t_model.arch, j_caches,
                                          device="cpu")
            for c, w in zip(caches, want_caches):
                assert sorted(c) == ["cross_k", "cross_v", "k", "v"]
                for k in c:
                    np.testing.assert_allclose(c[k].numpy(), w[k].numpy(),
                                               atol=1e-5)
        if not np.array_equal(got["tokens"], want):
            model, params, _ = pair
            for r in range(args.batch):
                a, b = want[r].tolist(), got["tokens"][r].tolist()
                if a == b:
                    continue
                step = next(i for i, (x, y) in enumerate(zip(a, b))
                            if x != y)
                lg = model.forward(params, {
                    "tokens": jnp.asarray([list(got["prompt"][r])
                                           + a[:step]]),
                    "frontend_embeddings": jnp.asarray(
                        got["frames"][r:r + 1].numpy())})[0]
                top = np.sort(np.asarray(lg[0, -1]))[-2:]
                assert top[1] - top[0] < MARGIN, (impl, r, step, a, b)


def test_continuous_engine_and_cli_refuse_encdec(pair, capsys):
    """JAX's continuous engine serves no encdec arch; the port refuses it
    with JAX's text, and the launcher with JAX's ``--engine continuous``
    error (its static engine serves it)."""
    with pytest.raises(ValueError) as e:
        ContinuousEngine(pair[2], num_slots=2, num_pages=8, page_size=4)
    assert str(e.value) == (
        "continuous engine serves families ('dense', 'moe', 'vlm', 'ssm', "
        "'hybrid'); whisper-base-smoke is 'encdec'")
    with pytest.raises(SystemExit):
        serve.main(["--arch", ENCDEC, "--smoke", "--device", "cpu",
                    "--engine", "continuous"])
    assert ("--engine continuous serves families ('dense', 'moe', 'vlm', "
            "'ssm', 'hybrid'); whisper-base-smoke is 'encdec' (use --engine "
            "static)") in capsys.readouterr().err
    out = serve.main(["--arch", ENCDEC, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen-len",
                      "3"])
    assert out["tokens"].shape == (2, 3)
    line = capsys.readouterr().out
    assert "(encoder 16 frames" in line and "cross K/V fill" in line


def test_weight_bridge_round_trip_and_init(pair):
    """The port's tree (encoder list, cross blocks) goes back to JAX's leaf
    for leaf; the port's own init has the JAX tree's names and shapes."""
    _, params, t_model = pair
    got = to_jax_layout(t_model.params)
    assert jax.tree.structure(got) == jax.tree.structure(params)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_array_equal(g, w)
    blk = t_model.params["blocks"][0]
    assert sorted(blk) == ["attn", "ln1", "ln2", "ln_x", "mlp", "xattn"]
    assert sorted(blk["xattn"]) == ["bk", "bo", "bq", "bv", "wk", "wo",
                                    "wq", "wv"]
    assert sorted(t_model.params["enc_blocks"][0]) == ["attn", "ln1", "ln2",
                                                        "mlp"]
    arch = dataclasses.replace(smoke_config(ENCDEC), enc_seq_len=FRAMES)
    own = to_jax_layout(Model.init(arch, torch.Generator().manual_seed(0),
                                   device="cpu").params)
    assert jax.tree.structure(own) == jax.tree.structure(params)
    for g, w in zip(jax.tree.leaves(own), jax.tree.leaves(params)):
        assert g.shape == w.shape


@pytest.mark.parametrize("name", ["qwen2-vl-2b", "whisper-base"])
def test_analytical_model_matches_jax(name):
    """``param_count``, ``transformer_gemms`` (three phases) and
    ``nongemm_ops`` equal JAX's under ``==`` for the full config and its
    smoke reduction."""
    for t_arch, j_arch in ((get_config(name), jax_get_config(name)),
                           (smoke_config(name), jax_smoke_config(name))):
        assert t_arch.param_count() == j_arch.param_count()
        for phase in ("fwd", "bwd_act", "bwd_w"):
            assert [dataclasses.astuple(g) for g in
                    analytical.transformer_gemms(t_arch, 2, 128, phase)] == \
                [dataclasses.astuple(g) for g in
                 janalytical.transformer_gemms(j_arch, 2, 128, phase)]
        assert [dataclasses.astuple(o) for o in
                analytical.nongemm_ops(t_arch, 2, 128)] == \
            [dataclasses.astuple(o) for o in
             janalytical.nongemm_ops(j_arch, 2, 128)]


def test_no_kernel_launch_on_the_cpu(pair):
    counts = (flash_ops.LAUNCHES, samp_ops.LAUNCHES)
    before = [dict(c) for c in counts]
    serve.run_static(_with_impl(pair[2], "flash"), argparse.Namespace(
        batch=1, prompt_len=70, gen_len=2, temperature=0.8, top_k=5,
        top_p=0.9, seed=0))
    assert [dict(c) for c in counts] == before
