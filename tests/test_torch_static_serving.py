"""The port's static engine (``Model.init_caches`` / ``prefill`` /
``decode_step``, ``launch.serve.run_static``) against the JAX static engine
on the same converted fp32 smoke weights, and against the port's own
continuous engine.

- llama3.2-3b smoke (attn_chunk 64) with ``attn_impl`` naive, chunked and
  flash, prompts of 40, 128 and 200 tokens: prefill logits within 1e-4,
  caches (through ``caches_from_jax``) within 1e-5, greedy decode steps
  with identical tokens. JAX's flash runs its chunked path on the CPU, the
  port's its plain flash version (p V in fp32).
- mamba2-1.3b smoke: the same through ``extend_mamba``, which is also held
  to JAX's on its own with a non-zero incoming state.
- ``run_static`` against ``run_continuous`` on the same prompts and seeds:
  greedy and seeded-sampled streams equal.
- the launcher: ``--engine static`` (the default) for both archs on the
  CPU."""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro.models import ssm as jssm
from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve
from repro_torch.models import ssm
from repro_torch.models.convert import caches_from_jax, from_jax_params
from repro_torch.models.model import Model

torch.set_num_threads(2)

LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5
LLAMA, MAMBA = "llama3.2-3b", "mamba2-1.3b"
_BASES = {}


def _base(name):
    """(JAX arch, JAX params, port model), fp32, built once per arch."""
    if name not in _BASES:
        arch = dataclasses.replace(jax_smoke_config(name), dtype="float32",
                                   param_dtype="float32")
        params = build_model(arch).init(jax.random.key(0))
        t_arch = dataclasses.replace(smoke_config(name), dtype="float32")
        t_model = Model(t_arch, from_jax_params(
            t_arch, jax.tree.map(np.asarray, params), device="cpu"))
        _BASES[name] = (arch, params, t_model)
    return _BASES[name]


def _pair(name, impl=None):
    """The JAX model, its params and the port model, with ``attn_impl``
    set on both configs."""
    arch, params, t_model = _base(name)
    t_arch = t_model.arch
    if impl is not None:
        arch = dataclasses.replace(arch, attn_impl=impl)
        t_arch = dataclasses.replace(t_arch, attn_impl=impl)
    return build_model(arch), params, Model(t_arch, t_model.params)


def _assert_caches(t_arch, j_caches, t_caches):
    want = caches_from_jax(t_arch, jax.tree.map(np.asarray, j_caches),
                           device="cpu")
    assert len(want) == len(t_caches) == t_arch.num_layers
    for a, b in zip(want, t_caches):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_allclose(b[key].numpy(), a[key].numpy(),
                                       atol=CACHE_ATOL, rtol=0, err_msg=key)


def _static_vs_jax(name, impl, plen, batch=2, steps=3):
    model, params, t_model = _pair(name, impl)
    vocab = t_model.arch.vocab_size
    prompt = np.random.default_rng(plen).integers(5, vocab, (batch, plen))
    j_caches = model.init_caches(None, batch, plen + steps + 1)
    t_caches = t_model.init_caches(batch, plen + steps + 1)
    j_logits, j_caches = jax.jit(model.prefill)(
        params, j_caches, {"tokens": jnp.asarray(prompt)})
    t_logits, t_caches = t_model.prefill(t_caches, torch.as_tensor(prompt))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=LOGIT_ATOL, rtol=0)
    _assert_caches(t_model.arch, j_caches, t_caches)
    decode = jax.jit(model.decode_step)
    j_tok = jnp.argmax(j_logits[:, -1], axis=-1)
    t_tok = torch.argmax(t_logits[:, -1], dim=-1)
    for i in range(steps):
        assert t_tok.tolist() == np.asarray(j_tok).tolist(), i
        j_logits, j_caches = decode(params, j_caches, {
            "tokens": j_tok[:, None],
            "positions": jnp.full((batch,), plen + i, jnp.int32)})
        t_logits, t_caches = t_model.decode_step(
            t_caches, t_tok[:, None],
            torch.full((batch,), plen + i, dtype=torch.int64))
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   atol=LOGIT_ATOL, rtol=0)
        j_tok = jnp.argmax(j_logits[:, -1], axis=-1)
        t_tok = torch.argmax(t_logits[:, -1], dim=-1)
    _assert_caches(t_model.arch, j_caches, t_caches)


@pytest.mark.parametrize("plen", [40, 128, 200])
@pytest.mark.parametrize("impl", ["naive", "chunked", "flash"])
def test_llama_static_prefill_and_decode_match_jax(impl, plen):
    flash_ops.LAUNCHES["flash_attention"] = 0
    _static_vs_jax(LLAMA, impl, plen)
    assert flash_ops.LAUNCHES["flash_attention"] == 0   # plain on the CPU


@pytest.mark.parametrize("plen", [32, 64])
def test_mamba_static_prefill_and_decode_match_jax(plen):
    _static_vs_jax(MAMBA, None, plen)


def test_extend_mamba_matches_jax_with_incoming_state():
    """Two chunks of 16 after a non-zero conv tail and SSD state."""
    arch, params, t_model = _base(MAMBA)
    rng = np.random.default_rng(11)
    blk = jax.tree.map(lambda a: np.asarray(a)[0],
                       params["blocks"]["layer_0"]["mamba"])
    u = rng.normal(size=(2, 32, arch.d_model)).astype(np.float32)
    cache = {k: rng.normal(size=v.shape).astype(np.float32) * 0.5
             for k, v in jax.tree.map(np.asarray, jssm.init_mamba_cache(
                 arch, 2, jnp.float32)).items()}
    j_out, j_new = jssm.extend_mamba(arch, jax.tree.map(jnp.asarray, blk),
                                     jnp.asarray(u),
                                     jax.tree.map(jnp.asarray, cache))
    t_out, t_new = ssm.extend_mamba(
        t_model.arch, t_model.params["blocks"][0]["mamba"],
        torch.from_numpy(u), {k: torch.from_numpy(v)
                              for k, v in cache.items()})
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5,
                               rtol=0)
    for key in ("conv", "state"):
        np.testing.assert_allclose(t_new[key].numpy(), np.asarray(j_new[key]),
                                   atol=1e-5, rtol=0, err_msg=key)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ssm.extend_mamba(t_model.arch, t_model.params["blocks"][0]["mamba"],
                         torch.from_numpy(u[:, :24]),
                         {k: torch.from_numpy(v) for k, v in cache.items()})


def test_init_caches_shapes():
    llama, mamba = _base(LLAMA)[2], _base(MAMBA)[2]
    c = llama.init_caches(3, 50)
    a = llama.arch
    assert len(c) == a.num_layers
    assert c[0]["k"].shape == (3, 50, a.num_kv_heads, a.resolved_head_dim)
    assert c[0]["v"].dtype == torch.float32
    c = mamba.init_caches(3, 50)
    assert set(c[0]) == {"conv", "state"}
    assert c[0]["state"].dtype == torch.float32
    assert c[0]["conv"].shape[:2] == (3, mamba.arch.ssm.conv_width - 1)


def _args(**kw):
    base = dict(batch=3, prompt_len=80, gen_len=6, temperature=0.0, top_k=0,
                top_p=1.0, seed=4, slots=0, page_size=16, num_pages=0,
                prefix_cache=True, prefill_chunk=0, fused_decode=None)
    base.update(kw)
    return argparse.Namespace(**base)


SAMPLING = {"greedy": {},
            "filtered": dict(temperature=0.8, top_k=40, top_p=0.95),
            "temperature": dict(temperature=1.0)}
_CONTINUOUS = {}


def _continuous(name, sampling, plen):
    key = (name, sampling)
    if key not in _CONTINUOUS:
        _CONTINUOUS[key] = serve.run_continuous(
            _base(name)[2], _args(prompt_len=plen, **SAMPLING[sampling]))
    return _CONTINUOUS[key]


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("name,impl,plen", [
    (LLAMA, "naive", 80), (LLAMA, "chunked", 80), (LLAMA, "flash", 80),
    (MAMBA, None, 32)])
def test_static_streams_equal_continuous(name, impl, plen, sampling):
    """The same prompts and per-request seeds through both engines of the
    launcher: the static prefill (chunked / flash above attn_chunk 64)
    against the continuous engine's paged prefill chunks of 64."""
    _, _, t_model = _pair(name, impl)
    static = serve.run_static(t_model, _args(prompt_len=plen,
                                             **SAMPLING[sampling]))
    cont = _continuous(name, sampling, plen)
    assert static["tokens"].shape == (3, 6)
    np.testing.assert_array_equal(static["tokens"], cont["tokens"])


@pytest.mark.parametrize("name,plen", [(LLAMA, 80), (MAMBA, 32)])
def test_serve_cli_static_is_the_default(capsys, name, plen):
    out = serve.main(["--arch", name, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", str(plen),
                      "--gen-len", "3", "--temperature", "0.8", "--top-k",
                      "20"])
    assert out["tokens"].shape == (2, 3)
    assert "[serve/static]" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--arch", name, "--smoke", "--device", "cpu",
                    "--fused-decode"])
    assert "--engine continuous" in capsys.readouterr().err


def test_serve_cli_refuses_an_encoder_only_arch(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--arch", "bert-large", "--smoke", "--device", "cpu"])
    assert "no decode step" in capsys.readouterr().err
