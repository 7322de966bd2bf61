"""The port's training path against the JAX package at bert-large-smoke
(2 layers, d_model 128, vocab 512) in float32, B2 / S32, from one set of
weights: JAX's ``Model.init`` with every bias perturbed by seeded numpy
noise (JAX starts biases at zero, which would hide a bias fault),
converted with ``from_jax_params``.

- loss within 1e-5 relative and every gradient within 1e-5 absolute /
  1e-4 relative of ``jax.grad``, with the fused blocks on and off
  (``REPRO_FUSED_BLOCKS``; on the CPU both sides run the kernels' plain
  versions);
- three steps of ``build_train_step`` against JAX's (``zero1=False``, as
  its trainer, and ``zero1=True``, its step builder's default, on one
  device): LAMB with the fused kernels' path on and off, with master
  weights on and off, and AdamW; params, ``m``, ``v`` and ``master``
  (with ``zero1`` in JAX's flat shapes, padding included) within 1e-5
  absolute / 1e-4 relative. One exception, AdamW's params
  where JAX's first gradient is below 1e-7 (10 eps; about a sixth of the
  elements here, among them the key bias, whose exact gradient is 0):
  AdamW's first step there is g / (|g| + eps), which turns the two
  frameworks' fp32 rounding noise in g into O(1) differences of the step
  direction, so those weights are held within 1e-2 (three steps of at
  most about 1.7 lr each, in either direction). LAMB normalizes by the
  global gradient norm first and needs no exception;
- ``SyntheticPipeline`` batches bitwise equal to JAX's;
- the trainer's loss falls over 30 smoke steps, and ``train_loop`` keeps
  one step in flight, as in ``tests/test_system.py``.
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
from repro.models import build_model
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train.steps import build_train_step as jax_build_train_step
from repro_torch import tree
from repro_torch.configs import RunConfig, ShapeConfig, smoke_config
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.models import model as model_lib
from repro_torch.models.convert import (from_jax_params, state_to_jax,
                                        to_jax_layout)
from repro_torch.optim import zero
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.steps import build_train_step

torch.set_num_threads(2)

B, S = 2, 32
BIASES = ("bias", "bqkv", "bo", "b1", "b2")


def _archs():
    j = dataclasses.replace(jax_smoke_config("bert-large"), dtype="float32",
                            param_dtype="float32")
    t = dataclasses.replace(smoke_config("bert-large"), dtype="float32",
                            param_dtype="float32")
    return j, t


@pytest.fixture(scope="module")
def setup():
    """(JAX arch, port arch, JAX model, numpy params, a batch)."""
    j_arch, t_arch = _archs()
    model = build_model(j_arch)
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0)))
    rng = np.random.default_rng(0)

    def perturb(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name in BIASES:
            return (leaf + 0.1 * rng.normal(size=leaf.shape)
                    ).astype(np.float32)
        return leaf
    params = jax.tree_util.tree_map_with_path(perturb, params)
    data = JaxPipeline(JaxDataConfig(vocab_size=j_arch.vocab_size,
                                     seq_len=S, global_batch=B,
                                     objective="mlm", seed=0))
    return j_arch, t_arch, model, params, data


def _port_params(t_arch, params):
    return from_jax_params(t_arch, params, device="cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _assert_trees_close(got, want, what, loose=None):
    """Every leaf within 1e-5 absolute / 1e-4 relative; where the tree of
    masks ``loose`` is True, within 1e-2 absolute instead."""
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    masks = {} if loose is None else dict(
        jax.tree_util.tree_leaves_with_path(loose))
    assert len(flat_g) == len(flat_w), what
    for path, g in flat_g:
        w = np.asarray(flat_w[path], np.float32)
        lo = masks.get(path, np.zeros(w.shape, bool))
        np.testing.assert_allclose(
            g[~lo], w[~lo], atol=1e-5, rtol=1e-4,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")
        np.testing.assert_allclose(
            g[lo], w[lo], atol=1e-2, rtol=0,
            err_msg=f"{what} {jax.tree_util.keystr(path)} (tiny gradient)")


def test_biases_are_perturbed(setup):
    _, _, _, params, _ = setup
    assert np.abs(params["mlm"]["bias"]).max() > 0.05
    assert np.abs(params["blocks"]["layer_0"]["mlp"]["b1"]).max() > 0.05


@pytest.mark.parametrize("fused", ["0", "1"])
def test_loss_and_grads_match_jax(setup, fused, monkeypatch):
    monkeypatch.setenv("REPRO_FUSED_BLOCKS", fused)
    j_arch, t_arch, model, params, data = setup
    batch = data.batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: model.loss(p, jbatch), has_aux=True)(params)
    tparams = tree.map(lambda p: p.requires_grad_(True),
                       _port_params(t_arch, params))
    loss, met = model_lib.loss(t_arch, tparams, _torch_batch(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(met["accuracy"].item(),
                               float(jmet["accuracy"]), atol=1e-6)
    leaves = tree.leaves(tparams)
    grads = tree.unflatten(tparams, list(torch.autograd.grad(loss, leaves)))
    _assert_trees_close(to_jax_layout(grads), jax.tree.map(np.asarray,
                                                           jgrads), "grad")


def _jax_state(run, params):
    """JAX ``build_train_step(run).init`` from the given params."""
    opt = jax_make_optimizer(run)
    p = jax.tree.map(jnp.asarray, params)
    state = {"opt": opt.init(p)}
    state["params"] = jax.tree.map(
        lambda x: x.astype(jnp.dtype(run.arch.dtype)), p) \
        if run.master_weights else p
    return state


CASES = [dict(optimizer="lamb", fused_optimizer_kernel=False,
              master_weights=True),
         dict(optimizer="lamb", fused_optimizer_kernel=True,
              master_weights=True),
         dict(optimizer="lamb", fused_optimizer_kernel=True,
              master_weights=False),
         dict(optimizer="lamb", fused_optimizer_kernel=False,
              master_weights=False),
         dict(optimizer="adamw", fused_optimizer_kernel=False,
              master_weights=True),
         dict(optimizer="lamb", fused_optimizer_kernel=False,
              master_weights=True, zero1=True),
         dict(optimizer="lamb", fused_optimizer_kernel=True,
              master_weights=True, zero1=True),
         dict(optimizer="lamb", fused_optimizer_kernel=True,
              master_weights=False, zero1=True),
         dict(optimizer="adamw", fused_optimizer_kernel=False,
              master_weights=True, zero1=True)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k[:6]}={v}" for k, v in c.items()))
def test_three_train_steps_match_jax(setup, case):
    j_arch, t_arch, model, params, data = setup
    loose = None
    if case["optimizer"] == "adamw":
        first = {k: jnp.asarray(v) for k, v in data.batch(0).items()}
        g0 = jax.grad(lambda p: model.loss(p, first)[0])(params)
        loose = jax.tree.map(lambda g: np.abs(np.asarray(g)) < 1e-7, g0)
    kw = dict({"learning_rate": 1e-3, "zero1": False}, **case)
    j_run = JaxRunConfig(arch=j_arch, shape=JaxShapeConfig(
        "t", seq_len=S, global_batch=B, kind="train"), **kw)
    t_run = RunConfig(arch=t_arch, shape=ShapeConfig(
        "t", seq_len=S, global_batch=B, kind="train"), **kw)
    j_step = jax.jit(jax_build_train_step(j_run).fn)
    j_state = _jax_state(j_run, params)
    bundle = build_train_step(t_run, device="cpu")
    t_state = bundle.init(params=_port_params(t_arch, params))
    for step in range(3):
        batch = data.batch(step)
        j_state, j_met = j_step(j_state, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        t_state, t_met = bundle.fn(t_state, batch)
        np.testing.assert_allclose(t_met["loss"].item(),
                                   float(j_met["loss"]), rtol=1e-5)
        np.testing.assert_allclose(t_met["grad_norm"].item(),
                                   float(j_met["grad_norm"]), rtol=1e-4)
    jp = jax.tree.map(np.asarray, j_state)
    _assert_trees_close(to_jax_layout(t_state["params"]), jp["params"],
                        "params", loose)
    for k in ("m", "v", "master"):
        assert (k in t_state["opt"]) == (k in jp["opt"]), k
        if k in jp["opt"]:
            # with zero1 in JAX's flat shapes, padding included
            got = zero.to_jax_layout(t_state["opt"][k], bundle.plan) \
                if kw["zero1"] else to_jax_layout(t_state["opt"][k])
            _assert_trees_close(got, jp["opt"][k], k)
    assert int(t_state["opt"]["step"]) == int(jp["opt"]["step"]) == 3


def test_microbatched_grads_match_jax(setup):
    """Two micro-batches: fp32-averaged gradients and averaged metrics."""
    j_arch, t_arch, model, params, data = setup
    from repro.optim import grad as jgrad
    from repro_torch.optim import grad as tgrad
    batch = data.batch(1)
    jg, jm = jgrad.accumulate_microbatches(
        lambda p, b: model.loss(p, b), jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, 2)
    tparams = tree.map(lambda p: p.requires_grad_(True),
                       _port_params(t_arch, params))
    tg, tm = tgrad.accumulate_microbatches(
        lambda p, b: model_lib.loss(t_arch, p, b), tparams,
        _torch_batch(batch), 2)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    _assert_trees_close(to_jax_layout(tg), jax.tree.map(np.asarray, jg),
                        "microbatched grad")


@pytest.mark.parametrize("objective", ["mlm", "causal"])
def test_pipeline_batches_bitwise_equal_to_jax(objective):
    kw = dict(vocab_size=30522, seq_len=128, global_batch=8,
              objective=objective, seed=3)
    j, t = JaxPipeline(JaxDataConfig(**kw)), SyntheticPipeline(
        DataConfig(**kw))
    for step in (0, 1, 7):
        jb, tb = j.batch(step), t.batch(step)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])
    it = t.iterator(start_step=5)
    np.testing.assert_array_equal(next(it)["tokens"], j.batch(5)["tokens"])


def test_trainer_learns_end_to_end_on_cpu():
    from repro_torch.launch.train import main
    out = main(["--smoke", "--device", "cpu", "--batch", "8", "--seq", "32",
                "--steps", "30"])
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))


def test_trainer_refuses_what_is_not_ported():
    """What the trainer still refuses: a checkpoint of a ZeRO state (JAX's
    trainer never writes one: its launcher passes ``zero1=False``, as the
    port's does). The ZeRO layout itself, refused until it was ported, now
    trains (``tests/test_torch_zero.py``, ``test_torch_dp_training.py``);
    so does a gradient through the flash kernel
    (``tests/test_torch_flash_grad.py`` holds it against JAX's)."""
    _, t_arch = _archs()
    run = RunConfig(arch=t_arch, shape=ShapeConfig("t", 8, 2, "train"))
    bundle = build_train_step(run, device="cpu")
    with pytest.raises(NotImplementedError, match="ZeRO"):
        state_to_jax(bundle.init(0))
    flash = dataclasses.replace(smoke_config("llama3.2-3b"),
                                attn_impl="flash")
    bundle = build_train_step(RunConfig(
        arch=flash, shape=ShapeConfig("t", 2 * flash.attn_chunk, 2, "train"),
        zero1=False), device="cpu")
    data = SyntheticPipeline(DataConfig(vocab_size=flash.vocab_size,
                                        seq_len=2 * flash.attn_chunk,
                                        global_batch=2))
    _, met = bundle.fn(bundle.init(0), data.batch(0))
    assert np.isfinite(met["loss"].item())


def test_train_loop_keeps_one_step_in_flight():
    """Step N's metrics are read only after step N+1 was dispatched (only
    the very first log line reads its own step), and the history still
    holds plain floats for every step."""
    events = []

    class DeviceMetric:
        """Stands in for a device scalar; records when it is read."""
        def __init__(self, step):
            self.step = step

        def __float__(self):
            events.append(("sync", self.step))
            return float(self.step) + 0.5

    def step_fn(state, batch):
        events.append(("dispatch", state))
        return state + 1, {"loss": DeviceMetric(state)}

    data = SyntheticPipeline(DataConfig(vocab_size=50, seq_len=8,
                                        global_batch=2))
    cfg = LoopConfig(max_steps=10, log_every=4,
                     straggler_factor=1e9)
    out = train_loop(step_fn, 0, data, cfg, log=lambda s: None)
    assert [h["loss"] for h in out["history"]] == [s + 0.5 for s in range(10)]
    assert all(isinstance(h["loss"], float) for h in out["history"])
    order = {e: i for i, e in enumerate(events)}
    for s in range(1, 9):
        assert order[("sync", s)] > order[("dispatch", s + 1)], s
    assert order[("sync", 9)] > order[("dispatch", 9)]
    # with a checkpoint manager the loop saves every ckpt_every steps
    # (asynchronously, a step's state as it stands) and at the end
    saves = []

    class Manager:
        def save_async(self, step, state, extra):
            saves.append(("async", step, state, extra["data_step"]))

        def wait(self):
            saves.append(("wait",))

        def save(self, step, state, extra):
            saves.append(("final", step, state, extra["data_step"]))
    train_loop(step_fn, 0, data, LoopConfig(max_steps=5, ckpt_every=2),
               ckpt=Manager(), log=lambda s: None)
    assert saves == [("async", 2, 2, 2), ("async", 4, 4, 4), ("wait",),
                     ("final", 5, 5, 5)]


def test_remat_recomputes_the_blocks_without_changing_grads(setup):
    """``arch.remat`` (per-block checkpoint) against remat off: equal
    gradients, bitwise, on the CPU."""
    _, t_arch, _, params, data = setup
    batch = _torch_batch(data.batch(2))
    out = []
    for remat in (True, False):
        arch = dataclasses.replace(t_arch, remat=remat)
        p = tree.map(lambda x: x.requires_grad_(True),
                     _port_params(arch, params))
        loss, _ = model_lib.loss(arch, p, batch)
        out.append(torch.autograd.grad(loss, tree.leaves(p)))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat", [True, False])
def test_fused_path_runs_each_kernel_forward_once_per_pass(remat,
                                                           monkeypatch):
    """The launch counts ``chip_smoke.py`` demands on the card, derived on
    the CPU: with the wrappers routed through ``PlainBackward`` (their card
    path) and their forwards counted, one fused step runs 2 norms and 1
    GeLU per block, twice with remat (the recompute in backward), and both
    LAMB stages once per parameter leaf."""
    import functools
    from repro_torch.kernels._grad import PlainBackward
    from repro_torch.kernels.bias_gelu import ops as bg_ops
    from repro_torch.kernels.bias_gelu import ref as bg_ref
    from repro_torch.kernels.fused_lamb import ops as lamb_ops
    from repro_torch.kernels.fused_layernorm import ops as ln_ops
    from repro_torch.kernels.fused_layernorm import ref as ln_ref
    calls = {"norm": 0, "gelu": 0, "lamb": 0}

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    def norm(x, r, s, b=None, *, eps=1e-5, rms=False):
        plain = functools.partial(ln_ref.fused_residual_layernorm, eps=eps,
                                  rms=rms)
        return PlainBackward.apply(counted("norm", plain), plain, x, r, s, b)

    def gelu(x, b=None):
        return PlainBackward.apply(counted("gelu", bg_ref.bias_gelu),
                                   bg_ref.bias_gelu, x, b)
    monkeypatch.setattr(ln_ops, "fused_residual_layernorm", norm)
    monkeypatch.setattr(bg_ops, "bias_gelu", gelu)
    monkeypatch.setattr(lamb_ops, "lamb_update_",
                        counted("lamb", lamb_ops.lamb_update_))
    monkeypatch.setenv("REPRO_FUSED_BLOCKS", "1")
    arch = dataclasses.replace(smoke_config("bert-large"), remat=remat)
    run = RunConfig(arch=arch, shape=ShapeConfig("t", S, B, "train"),
                    zero1=False, fused_optimizer_kernel=True)
    bundle = build_train_step(run, device="cpu")
    state = bundle.init(0)
    data = SyntheticPipeline(DataConfig(vocab_size=arch.vocab_size,
                                        seq_len=S, global_batch=B,
                                        objective="mlm"))
    bundle.fn(state, data.batch(0))
    passes = 2 if remat else 1
    assert calls == {"norm": 2 * arch.num_layers * passes,
                     "gelu": arch.num_layers * passes,
                     "lamb": len(tree.leaves(state["params"]))}
