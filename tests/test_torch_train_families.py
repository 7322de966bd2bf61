"""Training of every family, the port against the JAX package at smoke
size in float32, from one set of weights (the port's seeded init in JAX's
layout, ``to_jax_layout``, which JAX's ``Model.init`` would take seconds
an arch to make; every bias perturbed by seeded numpy noise; the port's
copy through ``from_jax_params``) on
JAX's batch of ``tests/test_configs_smoke.py`` (B2 / S32, frame embeddings
for whisper, M-RoPE positions for qwen2-vl):

- for every arch of the registry, the loss (``ce + aux``, the MoE's
  Switch loss included) within 1e-5 relative and every gradient leaf
  within 1e-5 absolute / 1e-4 relative (``_assert_trees_close``); neither
  side recomputes its blocks (remat changes no value: JAX compiles
  faster without it);
- with ``REPRO_FUSED_BLOCKS=1`` on both sides, the fused pre-norm block
  (the mixer's add + ln2 through ``decode_residual_norm``, JAX's
  ``fuse_pre_ln2``) at llama, deepseek-moe and whisper (whose decoder
  blocks keep the unfused pair around their cross-attention), the port
  recomputing each block (its checkpointed blocks return the Switch loss
  beside the activations), with its fused sites counted;
- three LAMB steps of llama, deepseek-moe, jamba and whisper
  (``build_train_step``, fused optimizer kernels' path on and off) against
  JAX's trainer state: params, ``m``, ``v``, ``master``; a MoE expert leaf
  takes one trust ratio an expert and a leaf of whisper's encoder one
  shared across its layers, as JAX's ``_layer_axes`` gives them. A leaf
  whose exact gradient is 0 (whisper's cross-attention key bias) updates
  by its weight decay plus fp32 noise that its trust ratio scales up, so
  where JAX's first gradient is below 1e-7 everywhere in a leaf, its
  params and master weights are held within 1e-2, as
  ``tests/test_torch_training.py`` holds AdamW's;
- the chunked attention's custom VJP against JAX's ``_chunked_attn`` at
  S 160 over chunks of 64 (causal, a window, GQA), and its saved tensors:
  q, k, v, kv_len, the output and the log-sum-exp only.

Each JAX model is built and differentiated once for the module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import ShapeConfig as JaxShapeConfig
from repro.configs import smoke_config as jax_smoke_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticPipeline as JaxPipeline
from repro.models import attention as jattn
from repro.models import build_model
from repro.optim import grad as jax_grad
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch import tree
from repro_torch.configs import REGISTRY, RunConfig, ShapeConfig, smoke_config
from repro_torch.kernels.fused_layernorm import ops as ln_ops
from repro_torch.models import attention as tattn
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tf
from repro_torch.models.convert import from_jax_params, to_jax_layout
from repro_torch.optim.lamb import trust_layout
from repro_torch.train.steps import build_train_step
from test_torch_training import _assert_trees_close

torch.set_num_threads(2)

B, S = 2, 32
BIASES = ("bias", "bqkv", "bo", "b1", "b2", "b3", "bq", "bk", "bv")
FUSED = ("llama3.2-3b", "deepseek-moe-16b", "whisper-base")
LAMB_ARCHS = ("llama3.2-3b", "deepseek-moe-16b", "jamba-v0.1-52b",
              "whisper-base")
_CACHE = {}


def _fp32(arch):
    return dataclasses.replace(arch, dtype="float32", param_dtype="float32",
                               remat=False)


def _jax_batch(arch):
    """``tests/test_configs_smoke.py``'s batch."""
    tokens = jax.random.randint(jax.random.key(2), (B, S), 5,
                                arch.vocab_size)
    batch = {"tokens": tokens, "targets": jnp.roll(tokens, -1, 1),
             "loss_mask": jnp.ones((B, S), jnp.bfloat16)}
    if arch.family == "encdec":
        batch["frontend_embeddings"] = jnp.ones(
            (B, arch.enc_seq_len, arch.d_model), jnp.bfloat16)
    if arch.frontend == "vision_stub":
        batch["mrope_positions"] = jnp.broadcast_to(
            jnp.arange(S)[None, None], (3, B, S)).astype(jnp.int32)
    return batch


def _torch_batch(batch):
    """numpy copies (bf16 masks and frames, all 0 or 1, as float32)."""
    return {k: torch.from_numpy(np.array(v.astype(jnp.float32) if v.dtype
                                         == jnp.bfloat16 else v))
            for k, v in batch.items()}


def _setup(name):
    """(JAX arch, port arch, JAX model, numpy params in JAX's layout with
    perturbed biases), built once for the module."""
    if name not in _CACHE:
        j_arch = _fp32(jax_smoke_config(name))
        t_arch = _fp32(smoke_config(name))
        model = build_model(j_arch)
        params = to_jax_layout(model_lib.init_params(
            t_arch, torch.Generator().manual_seed(0), "cpu", torch.float32),
            tf.period_length(t_arch))
        rng = np.random.default_rng(0)

        def perturb(path, leaf):
            if str(getattr(path[-1], "key", "")) in BIASES:
                return (leaf + 0.1 * rng.normal(size=leaf.shape)
                        ).astype(np.float32)
            return leaf
        params = jax.tree_util.tree_map_with_path(perturb, params)
        _CACHE[name] = (j_arch, t_arch, model, params)
    return _CACHE[name]


def _jax_grad_fn(name, fused):
    """JAX's ``value_and_grad`` of ``Model.loss``, jitted once an (arch,
    fused) pair: the gradient tests and the LAMB steps share it."""
    key = (name, "grad_fn", fused)
    if key not in _CACHE:
        model = _setup(name)[2]
        _CACHE[key] = jax.jit(jax.value_and_grad(model.loss, has_aux=True))
    return _CACHE[key]


def _jax_loss_and_grads(name, fused):
    j_arch, _, _, params = _setup(name)
    (loss, met), grads = _jax_grad_fn(name, fused)(params,
                                                   _jax_batch(j_arch))
    return (float(loss), {k: float(v) for k, v in met.items()},
            jax.tree.map(np.asarray, grads))


CASES = [(n, "0") for n in sorted(REGISTRY)] + [(n, "1") for n in FUSED]


@pytest.mark.parametrize("name,fused", CASES)
def test_loss_and_grads_match_jax(name, fused, monkeypatch):
    monkeypatch.setenv("REPRO_FUSED_BLOCKS", fused)
    j_arch, t_arch, _, params = _setup(name)
    t_arch = dataclasses.replace(t_arch, remat=fused == "1")
    jloss, jmet, jgrads = _jax_loss_and_grads(name, fused)
    sites = []
    real = ln_ops.decode_residual_norm

    def counted(*a, **k):
        sites.append(1)
        return real(*a, **k)
    monkeypatch.setattr(ln_ops, "decode_residual_norm", counted)
    tparams = tree.map(lambda p: p.requires_grad_(True),
                       from_jax_params(t_arch, params, device="cpu"))
    loss, met = model_lib.loss(t_arch, tparams,
                               _torch_batch(_jax_batch(j_arch)))
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert set(met) == set(jmet) == {"loss", "ce", "aux", "accuracy"}
    np.testing.assert_allclose(met["ce"].item(), jmet["ce"], rtol=1e-5)
    np.testing.assert_allclose(met["aux"].item(), jmet["aux"], rtol=1e-5,
                               atol=1e-8)
    assert (met["aux"].item() > 0) == (t_arch.moe is not None)
    grads = torch.autograd.grad(loss, tree.leaves(tparams))
    _assert_trees_close(
        to_jax_layout(tree.unflatten(tparams, list(grads)),
                      tf.period_length(t_arch)), jgrads, f"{name} grad")
    # the fused sites: every pre-norm block with an ln2 and no cross-
    # attention between its two norms, twice with the recompute
    want = 0
    if fused == "1" and not t_arch.post_norm:
        blocks = tparams["blocks"] + tparams.get("enc_blocks", [])
        want = 2 * sum("ln2" in b and "xattn" not in b for b in blocks)
    assert len(sites) == want


def _batch(arch, data, step):
    """The pipeline's batch ``step``, with ``_jax_batch``'s frame
    embeddings (ones) for an encdec arch."""
    batch = data.batch(step)
    if arch.family == "encdec":
        batch["frontend_embeddings"] = np.ones(
            (B, arch.enc_seq_len, arch.d_model), np.float32)
    return batch


def _jax_three_steps(name):
    """Three of JAX's trainer steps (``repro.train.steps``' step with one
    micro-batch: ``value_and_grad``, ``clip_by_global_norm``, LAMB's
    ``update``; master weights in fp32) from ``_setup``'s params, each
    part jitted on its own so the gradient's compile is the one the
    gradient test made; the batches' 0/1 loss masks and whisper's frames
    (ones) in bfloat16, as ``_jax_batch``'s."""
    key = (name, "lamb")
    if key not in _CACHE:
        j_arch, _, _, params = _setup(name)
        run = JaxRunConfig(arch=j_arch, shape=JaxShapeConfig(
            "t", seq_len=S, global_batch=B, kind="train"),
            learning_rate=1e-3, zero1=False)
        opt = jax_make_optimizer(run)
        grad_fn = _jax_grad_fn(name, "0")
        clip = jax.jit(lambda g: jax_grad.clip_by_global_norm(
            g, run.grad_clip))
        update = jax.jit(opt.update)
        p = jax.tree.map(jnp.asarray, params)
        state = {"params": p, "opt": opt.init(p)}
        data = JaxPipeline(JaxDataConfig(vocab_size=j_arch.vocab_size,
                                         seq_len=S, global_batch=B, seed=0))
        mets = []
        for i in range(3):
            batch = {k: jnp.asarray(v).astype(jnp.bfloat16)
                     if k in ("loss_mask", "frontend_embeddings")
                     else jnp.asarray(v) for k, v in _batch(j_arch, data,
                                                            i).items()}
            (_, met), grads = grad_fn(state["params"], batch)
            if i == 0:
                # leaves whose exact gradient is 0 (whisper's cross-
                # attention key bias: softmax ignores a shift shared by
                # every key) get only fp32 noise, which the trust ratio
                # scales up to a step of its own in either framework
                loose = jax.tree.map(lambda g: np.full(
                    g.shape, np.abs(np.asarray(g)).max() < 1e-7), grads)
            grads, gnorm = clip(grads)
            new_p, new_opt = update(grads, state["opt"], state["params"])
            state = {"params": new_p, "opt": new_opt}
            mets.append({k: float(v) for k, v in dict(
                met, grad_norm=gnorm).items()})
        _CACHE[key] = (jax.tree.map(np.asarray, state), mets, data, loose)
    return _CACHE[key]


@pytest.mark.parametrize("fused_opt", [False, True])
@pytest.mark.parametrize("name", LAMB_ARCHS)
def test_three_lamb_steps_match_jax(name, fused_opt):
    _, t_arch, _, params = _setup(name)
    j_state, j_mets, data, loose = _jax_three_steps(name)
    run = RunConfig(arch=t_arch, shape=ShapeConfig("t", S, B, "train"),
                    learning_rate=1e-3, zero1=False,
                    fused_optimizer_kernel=fused_opt)
    bundle = build_train_step(run, device="cpu")
    state = bundle.init(params=from_jax_params(t_arch, params, device="cpu"))
    for i in range(3):
        state, met = bundle.fn(state, _batch(t_arch, data, i))
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(met[k].item(), j_mets[i][k],
                                       rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(met["grad_norm"].item(),
                                   j_mets[i]["grad_norm"], rtol=1e-4)
    period = tf.period_length(t_arch)
    _assert_trees_close(to_jax_layout(state["params"], period),
                        j_state["params"], "params", loose)
    for k in ("m", "v", "master"):
        _assert_trees_close(to_jax_layout(state["opt"][k], period),
                            j_state["opt"][k], k,
                            loose if k == "master" else None)
    assert int(state["opt"]["step"]) == int(j_state["opt"]["step"]) == 3


def test_trust_ratios_are_per_expert_and_per_encoder_stack():
    """``trust_layout``: a MoE expert leaf [E, ...] has E rows, every
    other leaf one; whisper's encoder leaves are grouped across layers
    (JAX stacks them into one leaf with one ratio), its decoder's not."""
    arch = smoke_config("deepseek-moe-16b")
    params = model_lib.init_params(arch, torch.Generator().manual_seed(0),
                                   "cpu", torch.float32)
    rows = [r for r, _ in trust_layout(params)]
    experts = [t for b in params["blocks"] if "moe" in b
               for t in tree.leaves(b["moe"]["experts"])]
    assert experts and all(t.shape[0] == arch.moe.num_experts
                           for t in experts)
    assert rows.count(arch.moe.num_experts) == len(experts)
    assert set(rows) == {1, arch.moe.num_experts}
    arch = smoke_config("whisper-base")
    params = model_lib.init_params(arch, torch.Generator().manual_seed(0),
                                   "cpu", torch.float32)
    layout = trust_layout(params)
    groups = [g for _, g in layout if g is not None]
    n_enc = len(tree.leaves(params["enc_blocks"]))
    assert len(groups) == n_enc
    assert len(set(groups)) == n_enc // arch.enc_layers


ATTN = [dict(causal=True, hq=4, hkv=4, window=0),
        dict(causal=True, hq=4, hkv=4, window=48),
        dict(causal=True, hq=8, hkv=2, window=0),
        dict(causal=False, hq=8, hkv=2, window=0)]


@pytest.mark.parametrize("case", ATTN, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_chunked_vjp_matches_jax(case):
    rng = np.random.default_rng(case["hq"] + case["window"])
    d, sq, chunk = 16, 160, 64
    q = rng.normal(size=(2, sq, case["hq"], d)).astype(np.float32)
    k, v = (rng.normal(size=(2, sq, case["hkv"], d)).astype(np.float32)
            for _ in range(2))
    ct = rng.normal(size=q.shape).astype(np.float32)
    kw = dict(causal=case["causal"], chunk=chunk, window=case["window"])
    out, vjp = jax.vjp(lambda a, b, c: jattn.chunked_attention(a, b, c, **kw),
                       q, k, v)
    want = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = tattn.chunked_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-5)
    grads = torch.autograd.grad(got, [tq, tk, tv], torch.from_numpy(ct))
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_chunked_vjp_saves_only_its_residuals():
    """What the forward keeps for the backward: q, k and v (padded to the
    chunk multiple), kv_len, the output and the log-sum-exp, never a
    score tile."""
    saved = []
    q = torch.randn(2, 160, 4, 16, requires_grad=True)
    k = torch.randn(2, 160, 2, 16, requires_grad=True)
    v = torch.randn(2, 160, 2, 16, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        out = tattn.chunked_attention(q, k, v, causal=True, chunk=64)
    assert sorted(saved) == sorted([(2, 160, 4, 16), (2, 192, 2, 16),
                                    (2, 192, 2, 16), (2,), (2, 160, 4, 16),
                                    (2, 4, 160)])
    out.sum().backward()
    assert q.grad is not None and k.grad.shape == k.shape
