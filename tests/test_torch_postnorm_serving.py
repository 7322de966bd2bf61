"""Post-norm stacks on the port's serving paths, against the JAX package on
the same converted fp32 smoke weights.

- bert-large smoke (post-norm, learned positions, MLM head): the static
  ``Model.prefill`` logits within 1e-4 of JAX's, then greedy
  ``decode_step`` logits the same way (JAX's ``Model.decode_step`` runs
  them for an encoder-only arch too);
- llama3.2-3b smoke with ``post_norm=True``: greedy streams identical to
  JAX's on the static engine (``run_static`` against JAX's prefill and
  decode steps) and on the continuous engine with fused decode requested,
  which both engines turn off with the same reason;
- the continuous engine refuses an encoder-only arch, as JAX's does, and
  reports JAX's fused-decode off reasons in JAX's order;
- both continuous engines refuse an attention arch whose positions or
  window the paged decode path cannot apply (a sliding window, learned
  positions), with JAX's messages, while the static engine serves it and
  its greedy stream matches JAX's."""
import argparse
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs import smoke_config
from repro_torch.launch import serve
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import Model
from repro_torch.serving import ContinuousEngine, Request

torch.set_num_threads(2)

LOGIT_ATOL = 1e-4
BERT, LLAMA = "bert-large", "llama3.2-3b"
_BASES = {}


def _base(name, **over):
    """(JAX model, JAX params, port model), fp32, built once per arch and
    override."""
    key = (name, tuple(sorted(over.items())))
    if key not in _BASES:
        arch = dataclasses.replace(jax_smoke_config(name), dtype="float32",
                                   param_dtype="float32", **over)
        model = build_model(arch)
        params = model.init(jax.random.key(0))
        t_arch = dataclasses.replace(smoke_config(name), dtype="float32",
                                     **over)
        t_model = Model(t_arch, from_jax_params(
            t_arch, jax.tree.map(np.asarray, params), device="cpu"))
        _BASES[key] = (model, params, t_model)
    return _BASES[key]


def test_bert_static_prefill_and_decode_match_jax():
    model, params, t_model = _base(BERT)
    assert t_model.arch.post_norm and t_model.arch.mlm_transform
    batch, plen, steps = 2, 24, 3
    prompt = np.random.default_rng(0).integers(5, t_model.arch.vocab_size,
                                               (batch, plen))
    j_caches = model.init_caches(None, batch, plen + steps)
    t_caches = t_model.init_caches(batch, plen + steps)
    j_logits, j_caches = jax.jit(model.prefill)(
        params, j_caches, {"tokens": jnp.asarray(prompt)})
    t_logits, t_caches = t_model.prefill(t_caches, torch.as_tensor(prompt))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=LOGIT_ATOL, rtol=0)
    decode = jax.jit(model.decode_step)
    for i in range(steps):
        tok = np.array(jnp.argmax(j_logits[:, -1], axis=-1))
        assert torch.argmax(t_logits[:, -1], dim=-1).tolist() == tok.tolist()
        j_logits, j_caches = decode(params, j_caches, {
            "tokens": jnp.asarray(tok)[:, None],
            "positions": jnp.full((batch,), plen + i, jnp.int32)})
        t_logits, t_caches = t_model.decode_step(
            t_caches, torch.as_tensor(tok)[:, None],
            torch.full((batch,), plen + i, dtype=torch.int64))
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   atol=LOGIT_ATOL, rtol=0, err_msg=str(i))


def test_post_norm_llama_static_greedy_stream_matches_jax():
    model, params, t_model = _base(LLAMA, post_norm=True)
    args = argparse.Namespace(batch=2, prompt_len=40, gen_len=8,
                              temperature=0.0, top_k=0, top_p=1.0, seed=3)
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


def test_post_norm_llama_continuous_greedy_streams_match_jax():
    """Fused decode requested on both engines: each turns it off with
    JAX's reason and serves the unfused post-norm bodies."""
    model, params, t_model = _base(LLAMA, post_norm=True)
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(5, 512, n))) for n in (9, 14, 6)]
    gens = [7, 5, 9]
    kw = dict(num_slots=2, num_pages=40, page_size=8, max_seq_len=48,
              fused_decode=True)
    j_eng = JaxEngine(model, params, **kw)
    t_eng = ContinuousEngine(t_model, **kw)
    assert not t_eng.fused_decode and not j_eng.fused_decode
    assert t_eng.fused_decode_off_reason == j_eng.fused_decode_off_reason \
        == "fused decode requires a pre-norm stack"
    j_res = j_eng.run([JaxRequest(uid=i, prompt=p, max_new_tokens=g)
                       for i, (p, g) in enumerate(zip(prompts, gens))])
    t_res = t_eng.run([Request(uid=i, prompt=p, max_new_tokens=g)
                       for i, (p, g) in enumerate(zip(prompts, gens))])
    for i, g in enumerate(gens):
        assert len(t_res[i]["tokens"]) == g
        assert t_res[i]["tokens"] == j_res[i]["tokens"], i
    assert (t_eng.steps, t_eng.prefills) == (j_eng.steps, j_eng.prefills)


def test_continuous_engine_refuses_an_encoder_only_arch():
    _, _, t_model = _base(BERT)
    with pytest.raises(ValueError, match="encoder-only archs have no decode "
                                         "step"):
        ContinuousEngine(t_model, num_slots=2, num_pages=16, page_size=8)


PAGED_GUARDS = {
    "window": (dict(window=16), "paged decode-attention has no "
               "sliding-window masking yet"),
    "learned positions": (dict(pos_emb="learned"), "paged decode "
                          "re-derives positions from seq_lens "
                          "(rope/mrope/none only)"),
}


@pytest.mark.parametrize("guard", list(PAGED_GUARDS))
def test_continuous_engines_refuse_what_paged_decode_cannot_apply(guard):
    """JAX asserts, the port raises ValueError, with the same message."""
    over, msg = PAGED_GUARDS[guard]
    model, params, t_model = _base(LLAMA, **over)
    assert not t_model.arch.post_norm
    kw = dict(num_slots=2, num_pages=16, page_size=8, max_seq_len=48)
    with pytest.raises(AssertionError, match=re.escape(msg)):
        JaxEngine(model, params, **kw)
    with pytest.raises(ValueError, match=re.escape(msg)):
        ContinuousEngine(t_model, **kw)


@pytest.mark.parametrize("guard", list(PAGED_GUARDS))
def test_static_engine_serves_what_the_continuous_engine_refuses(guard):
    """A 40-token prompt, past the 16-token window: the port's static
    greedy stream equals JAX's prefill + decode steps."""
    model, params, t_model = _base(LLAMA, **PAGED_GUARDS[guard][0])
    args = argparse.Namespace(batch=2, prompt_len=40, gen_len=6,
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


@pytest.mark.parametrize("over,reason", [
    (dict(post_norm=True, mlm_transform=True),
     "fused decode requires a pre-norm stack"),
    (dict(mlm_transform=True),
     "fused decode does not support MLM-transform heads"),
    (dict(mlm_transform=True, tie_embeddings=False),
     "fused decode does not support MLM-transform heads"),
    (dict(tie_embeddings=False), None),
    (dict(), None),
])
def test_fused_decode_off_reasons_follow_jax_order(over, reason):
    """JAX's two reasons, in JAX's order, and no other: an untied head
    serves fused, as in JAX; the arch only, no weights are served."""
    arch = dataclasses.replace(smoke_config(LLAMA), **over)
    model = Model.init(arch, torch.Generator().manual_seed(0), device="cpu")
    eng = ContinuousEngine(model, num_slots=1, num_pages=8, page_size=8,
                           fused_decode=True)
    assert eng.fused_decode_off_reason == reason
    assert eng.fused_decode is (reason is None)
    off = ContinuousEngine(model, num_slots=1, num_pages=8, page_size=8,
                           fused_decode=False)
    assert off.fused_decode_off_reason is None and not off.fused_decode
