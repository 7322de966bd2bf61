"""The port's ZeRO-1 layout (``repro_torch.optim.zero``) and the optimizers
on it, one device, against the JAX package on the same numpy inputs:

- ``flatten_leaf`` / ``unflatten_leaf`` bitwise JAX's on random shapes,
  one row and three, pads 16 and 256; ``shard_range`` and the dp check;
- LAMB (plain and through the kernels' path) and AdamW with ``zero1``
  against JAX's ``lamb.update`` / ``adamw.update`` with ``zero1``, two
  steps on a tree with a scanned stack of three layers (an expert leaf
  among them), a two-layer encoder stack (one flat leaf across its
  layers) and plain leaves, and with the stack unscanned (period 3):
  params, and ``m``, ``v``, ``master`` in JAX's flat shapes, padding
  included (``zero.to_jax_layout``), within 1e-5 absolute / 1e-4
  relative (the trust ratio's and the global norm's sums run in another
  order);
- the ZeRO path's Stage 1 + 2 (``lamb_update_shards_``) against JAX's
  Pallas kernels run in interpret mode on the flat layout (one ratio a
  row, as JAX's kernel reduces it), w, m, v within 1e-6;
- a rank's shards and its blocks of the gradient buffer at dp 2, 4 and 8
  are its columns of the one-device flat leaves, bitwise;
- the training rules and specs are JAX's defaults, with each option
  of ``make_rules``; the train step refuses a table it cannot honour;
- a ZeRO ``build_train_step`` at dp=1 gives ``m``, ``v`` and ``master`` of
  the shapes JAX's ``init`` gives.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_lamb import ops as jlamb_ops
from repro.optim import adamw as jadamw
from repro.optim import lamb as jlamb
from repro.optim import zero as jzero
from repro_torch import tree
from repro_torch.kernels.fused_lamb import ops as lamb_ops
from repro_torch.models.convert import to_jax_layout
from repro_torch.optim import adamw, lamb, zero

torch.set_num_threads(2)

HYPER = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01, lr=3e-4)


@pytest.mark.parametrize("shape,z", [((37,), 0), ((5, 7), 0), ((3, 41), 1),
                                     ((3, 4, 5), 1), ((256,), 0),
                                     ((3, 256), 1)])
@pytest.mark.parametrize("multiple", [16, 256])
def test_flat_layout_bitwise_jax(shape, z, multiple):
    rng = np.random.default_rng(sum(shape) + multiple)
    x = rng.normal(size=shape).astype(np.float32)
    rows = shape[0] if z else 1
    got = zero.flatten_leaf(torch.from_numpy(x), rows, multiple)
    want = np.asarray(jzero.flatten_leaf(jnp.asarray(x), z, multiple))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    back = zero.unflatten_leaf(got, shape, torch.bfloat16)
    jback = jzero.unflatten_leaf(jnp.asarray(want), shape, z, jnp.bfloat16)
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(jback.astype(jnp.float32)))


def test_shard_range_and_dp_check():
    assert zero.shard_range(512, 0, 2) == (0, 256)
    assert zero.shard_range(512, 3, 4) == (384, 512)
    with pytest.raises(ValueError, match="dp=3 does not divide the ZeRO "
                                         "pad multiple 256"):
        zero.check_dp(3)
    zero.check_dp(64)


def _tree(period_layers=3):
    """A port tree: a decoder stack of three layers (a MoE expert leaf in
    each), a two-layer encoder stack, and leaves outside the stacks."""
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return {
        "embed": {"embedding": t(50, 8)},
        "final_norm": {"scale": t(8)},
        "blocks": [{"attn": {"wqkv": t(8, 24)}, "ln1": {"scale": t(8)},
                    "moe": {"experts": {"w1": t(4, 8, 6)},
                            "router": t(8, 4)}}
                   for _ in range(3)],
        "enc_blocks": [{"mlp": {"w1": t(8, 20)}, "ln1": {"bias": t(8)}}
                       for _ in range(2)],
    }


def _grads(params, step):
    rng = np.random.default_rng(100 + step)
    return tree.map(lambda p: torch.from_numpy(
        (0.01 * rng.normal(size=p.shape)).astype(np.float32)), params)


def _jax_tree(port_tree, period):
    """JAX's layout of a port tree, copied (a CPU tensor's numpy view would
    alias the port's leaves, which the port updates in place)."""
    return jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                        to_jax_layout(port_tree, period))


def _close(got, want, what):
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_g.keys() == flat_w.keys(), what
    for path, w in flat_w.items():
        g = flat_g[path]
        assert g.shape == np.shape(w), (what, path, g.shape, np.shape(w))
        np.testing.assert_allclose(
            g, np.asarray(w, np.float32), atol=1e-5, rtol=1e-4,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


CASES = [("lamb", False, True), ("lamb", True, True), ("lamb", True, False),
         ("lamb", False, False), ("adamw", False, False)]


@pytest.mark.parametrize("period", [1, 3])
@pytest.mark.parametrize("opt,fused,master", CASES)
def test_zero_optimizers_match_jax(opt, fused, master, period):
    params = _tree()
    jparams = _jax_tree(params, period)
    if opt == "lamb":
        cfg = lamb.LambConfig(zero1=True, use_fused_kernel=fused,
                              master_weights=master, learning_rate=1e-2)
        jcfg = jlamb.LambConfig(zero1=True, use_fused_kernel=fused,
                                master_weights=master, learning_rate=1e-2)
        mod, jmod, keys = lamb, jlamb, ("m", "v") + (("master",) if master
                                                      else ())
    else:
        cfg = adamw.AdamWConfig(zero1=True, learning_rate=1e-2)
        jcfg = jadamw.AdamWConfig(zero1=True, learning_rate=1e-2)
        mod, jmod, keys = adamw, jadamw, ("m", "v")
    plan = zero.Plan(params, period=period, layer_rows=opt == "lamb")
    state = mod.init(cfg, params, plan)
    jstate = jmod.init(jcfg, jparams)
    for step in range(2):
        g = _grads(params, step)
        mod.update(cfg, g, state, params, plan)
        jparams, jstate = jmod.update(jcfg, _jax_tree(g, period), jstate,
                                      jparams)
    _close(to_jax_layout(params, period), jparams, "params")
    for k in keys:
        _close(zero.to_jax_layout(state[k], plan), jstate[k], k)
    assert int(state["step"]) == int(jstate["step"]) == 2


def test_plan_groups_like_jax():
    """Flat leaves: a row a layer of the scanned stack (an expert leaf one
    an expert) for LAMB, one leaf across the encoder's layers; AdamW one
    row across the scanned stack's layers."""
    params = _tree()
    by = {u.path: u for u in zero.Plan(params).units}
    assert by[("blocks", 2, "moe", "experts", "w1")].rows == 4
    assert not by[("blocks", 2, "attn", "wqkv")].spans
    enc = by[("enc_blocks", 0, "mlp", "w1")]
    assert enc.spans and len(enc.members) == 2 and enc.n == 2 * 8 * 20
    assert enc.padded == 512
    adam = {u.path: u for u in zero.Plan(params, layer_rows=False).units}
    w = adam[("blocks", 0, "moe", "experts", "w1")]
    assert w.spans and w.rows == 1 and w.n == 3 * 4 * 8 * 6
    assert len(adam) == len(tree.leaves(params["blocks"][0])) + 2 + 2


@pytest.mark.parametrize("layer_rows", [True, False])
@pytest.mark.parametrize("dp", [2, 4, 8])
def test_plan_rank_columns_are_the_flat_leaves(dp, layer_rows):
    """Rank r of dp: ``shards`` of the params, and its block of the
    gradient buffer after two micro-batches' ``accumulate_``, are columns
    ``shard_range(padded, r, dp)`` of the one-device flat leaves (a leaf
    of one member ``flatten_leaf``'s; the
    encoder's leaf spans two layers whose members straddle the ranks'
    column blocks)."""
    params = _tree()
    whole = zero.Plan(params, layer_rows=layer_rows)
    flat = whole.shards(params)
    leaves = tree.leaves(params)
    for u, f in zip(whole.units, flat):
        if len(u.members) == 1:     # JAX's flatten_leaf, held bitwise above
            assert torch.equal(f, zero.flatten_leaf(leaves[u.members[0]],
                                                    u.rows, u.padded))
    acc1 = whole.accumulator("cpu")
    for step in range(2):
        whole.accumulate_(acc1, tree.leaves(_grads(params, step)), 2)
    acc_whole = whole.views(acc1)
    for r in range(dp):
        plan = zero.Plan(params, layer_rows=layer_rows, dp=dp, rank=r)
        acc = plan.accumulator("cpu")
        for step in range(2):
            plan.accumulate_(acc, tree.leaves(_grads(params, step)), 2)
        blocks = acc.view(dp, plan.chunk)
        for u, off, f, a, mine in zip(plan.units, plan.offsets, flat,
                                      acc_whole, plan.shards(params)):
            lo, hi = zero.shard_range(u.padded, r, dp)
            assert torch.equal(mine, f[:, lo:hi]), u.path
            for b in range(dp):
                lo, hi = zero.shard_range(u.padded, b, dp)
                got = blocks[b, off:off + u.rows * (hi - lo)].view(
                    u.rows, hi - lo)
                assert torch.equal(got, a[:, lo:hi]), (u.path, b)


@pytest.mark.parametrize("rows,cols", [(1, 256), (1, 2304), (3, 512),
                                       (4, 4096)])
def test_shard_update_matches_pallas_interpret(rows, cols):
    """Stage 1 + 2 on flat leaves [rows, padded] with zero padding columns
    against JAX's Pallas kernels (interpret mode): one ratio a row."""
    rng = np.random.default_rng(rows * cols)
    n = cols - 37                       # the padding stays zero
    w, g, m, v = (np.zeros((rows, cols), np.float32) for _ in range(4))
    w[:, :n] = rng.normal(size=(rows, n))
    g[:, :n] = 0.01 * rng.normal(size=(rows, n))
    m[:, :n] = 1e-3 * rng.normal(size=(rows, n))
    v[:, :n] = 1e-6 * rng.random((rows, n))
    sc = dict(ginv=0.7, c1=1.2, c2=1.1)
    want = jlamb_ops.lamb_stage12(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
        interpret=True, **sc, **HYPER)
    tw, tg, tm, tv = (torch.from_numpy(x.copy()) for x in (w, g, m, v))
    lamb_ops.lamb_update_shards_(
        [(tw, tg, tm, tv, rows)],
        torch.tensor([sc["ginv"], sc["c1"], sc["c2"]]), **HYPER)
    for got, exp in zip((tw, tm, tv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-6,
                                   rtol=0)
    assert not tw[:, n:].any() and not tm[:, n:].any()


def test_train_step_state_has_jax_shapes():
    """A ZeRO ``build_train_step`` (dp=1, one device): m, v and master in
    the shapes JAX's ``build_train_step(run).init`` gives them."""
    import dataclasses
    from repro.configs import RunConfig as JRun
    from repro.configs import ShapeConfig as JShape
    from repro.configs import smoke_config as jsmoke
    from repro.train.steps import build_train_step as jbuild
    from repro_torch.configs import RunConfig, ShapeConfig, smoke_config
    from repro_torch.train.steps import build_train_step
    from repro_torch.models.transformer import period_length
    j_arch = dataclasses.replace(jsmoke("deepseek-moe-16b"),
                                 dtype="float32", param_dtype="float32")
    t_arch = dataclasses.replace(smoke_config("deepseek-moe-16b"),
                                 dtype="float32", param_dtype="float32")
    shape = dict(name="t", seq_len=8, global_batch=2, kind="train")
    jstate = jax.eval_shape(jbuild(JRun(arch=j_arch,
                                        shape=JShape(**shape))).init)
    bundle = build_train_step(RunConfig(arch=t_arch, shape=ShapeConfig(
        **shape)), device="cpu")
    state = bundle.init(0)
    for k in ("m", "v", "master"):
        got = jax.tree.map(np.shape, zero.to_jax_layout(state["opt"][k],
                                                        bundle.plan))
        want = jax.tree.map(lambda s: s.shape, jstate["opt"][k])
        assert got == want, k
    assert bundle.plan.period == period_length(t_arch)


@pytest.mark.parametrize("kw", [{"multi_pod": True,
                                 "overrides": (("vocab", None),)},
                                {"overrides": (("opt_flat", "data"),)},
                                {"overrides": (("tensor", None),)}],
                         ids=["multi_pod", "opt_flat", "tensor"])
def test_train_step_refuses_rules_it_cannot_honour(kw):
    """The step honours the ``make_rules`` tables of its four options
    (the meshes' tests run them, ``multi_pod`` among them) and refuses
    any other table, such as a ``multi_pod`` one with an override,
    before it builds anything."""
    from repro_torch.configs import RunConfig, ShapeConfig, smoke_config
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.steps import build_train_step
    run = RunConfig(arch=smoke_config("llama3.2-3b"), shape=ShapeConfig(
        "t", seq_len=8, global_batch=2, kind="train"))
    with pytest.raises(NotImplementedError,
                       match="an overrides table is not ported"):
        build_train_step(run, device="cpu", rules=make_rules(**kw))


@pytest.mark.parametrize("seq", [True, False])
def test_train_step_honours_multi_pod_tables(seq):
    """A ``make_rules(multi_pod=True)`` table is one the step honours
    (``tests/test_torch_pod_training.py`` trains it over a pod axis); on
    one device it is the step of one device."""
    from repro_torch.configs import RunConfig, ShapeConfig, smoke_config
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.steps import build_train_step
    run = RunConfig(arch=smoke_config("llama3.2-3b"), shape=ShapeConfig(
        "t", seq_len=8, global_batch=2, kind="train"))
    bundle = build_train_step(run, device="cpu", rules=make_rules(
        multi_pod=True, seq_parallel=seq))
    assert bundle.mesh.rules["batch"] == ("pod", "data")
    assert bundle.mesh.batch is None and bundle.mesh.pods == 1


def test_training_rules_and_specs_are_jax():
    """``TRAIN_RULES`` JAX's default table; ``batch_pspecs``,
    ``opt_state_pspecs`` and ``flat_grad_pspec`` JAX's specs under it (a
    spec a tuple of per-dim entries, as ``PartitionSpec``'s)."""
    from jax.sharding import Mesh
    from repro.parallel import sharding as jsh
    from repro_torch.parallel import sharding as sh
    assert sh.TRAIN_RULES == jsh.make_rules()
    batch = {"tokens": np.zeros((4, 8)), "mrope_positions": np.zeros(
        (3, 4, 8)), "frontend_embeddings": np.zeros((4, 6, 2)),
        "scalar": np.zeros(())}
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    state = {"m": {"embed": {"embedding": np.zeros((1, 512))},
                   "blocks": {"layer_0": {"moe": {"experts": {
                       "w1": np.zeros((4, 256))}}}}},
             "step": np.zeros(())}
    flat = np.zeros((4, 256))
    with jsh.activate(mesh, jsh.make_rules()):
        want = jsh.batch_pspecs(batch)
        jopt = jsh.opt_state_pspecs(state, None, True)
        jflat = jsh.flat_grad_pspec((jax.tree_util.DictKey("experts"),),
                                    flat)

    def one(sp):        # PartitionSpec writes a one-axis tuple as the axis
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in sp)
    assert {k: tuple(v) for k, v in want.items()} == {
        k: one(v) for k, v in sh.batch_pspecs(batch).items()}
    opt = sh.opt_state_pspecs(state, None, True)
    assert opt["step"] == tuple(jopt["step"])
    assert opt["m"]["embed"]["embedding"] == tuple(
        jopt["m"]["embed"]["embedding"])
    assert opt["m"]["blocks"]["layer_0"]["moe"]["experts"]["w1"] == tuple(
        jopt["m"]["blocks"]["layer_0"]["moe"]["experts"]["w1"])
    assert sh.flat_grad_pspec(flat) == tuple(jflat)


def test_local_slice_cuts_the_rank_blocks():
    from repro_torch.parallel import sharding as sh
    sizes = {"data": 4, "model": 2}
    got = [sh.local_slice((None, ("data", "model")), (3, 64), sizes,
                          {"data": d, "model": m})[1]
           for d in range(4) for m in range(2)]
    assert got == [slice(8 * i, 8 * (i + 1)) for i in range(8)]
    assert sh.local_slice((None, "data"), (2, 8), {}, {}) == (
        slice(0, 2), slice(0, 8))
    with pytest.raises(ValueError, match="does not split"):
        sh.local_slice(("data",), (6,), sizes, {"data": 0})


RULE_OPTIONS = [{}, {"multi_pod": True}, {"seq_parallel": False},
                {"fsdp": False}, {"expert_parallel": False},
                {"overrides": (("opt_flat", ("data", "model")),
                               ("seq", None))}]


@pytest.mark.parametrize("kw", RULE_OPTIONS,
                         ids=["defaults", "multi_pod", "no_seq", "no_fsdp",
                              "no_experts", "overrides"])
def test_make_rules_options_are_jax(kw):
    """``make_rules`` with each option is JAX's table; ``batch_pspecs``,
    the expert case of ``opt_state_pspecs`` and ``flat_grad_pspec`` under
    it are JAX's specs."""
    from jax.sharding import Mesh
    from repro.parallel import sharding as jsh
    from repro_torch.parallel import sharding as sh
    rules = sh.make_rules(**kw)
    assert rules == jsh.make_rules(**kw)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    batch = {"tokens": np.zeros((4, 8)),
             "mrope_positions": np.zeros((3, 4, 8))}
    state = {"m": {"blocks": {"layer_0": {"moe": {"experts": {
        "w1": np.zeros((4, 256))}}}}, "embed": {
        "embedding": np.zeros((1, 512))}}, "step": np.zeros(())}
    flat = np.zeros((4, 256))
    with jsh.activate(mesh, jsh.make_rules(**kw)):
        jbatch = jsh.batch_pspecs(batch)
        jopt = jsh.opt_state_pspecs(state, None, True)
        jflat = jsh.flat_grad_pspec(
            (jax.tree_util.DictKey("experts"),), flat)

    def one(sp):        # PartitionSpec writes a one-axis tuple as the axis
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in sp)
    assert {k: one(v) for k, v in sh.batch_pspecs(batch, rules).items()} \
        == {k: one(v) for k, v in jbatch.items()}
    opt = sh.opt_state_pspecs(state, None, True, rules)
    for path in (("blocks", "layer_0", "moe", "experts", "w1"),
                 ("embed", "embedding")):
        got, want = opt["m"], jopt["m"]
        for k in path:
            got, want = got[k], want[k]
        assert one(got) == one(want), path
    assert one(sh.flat_grad_pspec(flat, rules)) == one(jflat)


@pytest.mark.parametrize("kw", [{}, {"expert_parallel": False,
                                     "fsdp": False}],
                         ids=["defaults", "no_experts_no_fsdp"])
def test_param_pspecs_of_every_arch_are_jax(kw):
    """``param_pspecs`` of every registry arch's smoke params is JAX's on
    JAX's tree, leaf for leaf (JAX's scan axis a leading replicated dim);
    sanitized over a (16, 16) mesh, the same specs."""
    from jax.sharding import Mesh
    from repro.configs import REGISTRY
    from repro.configs import smoke_config as jax_smoke_config
    from repro.models import build_model
    from repro.parallel import sharding as jsh
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as model_lib
    from repro_torch.models.transformer import period_length
    from repro_torch.parallel import sharding as sh
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    sizes = {"data": 16, "model": 16}
    for name in REGISTRY:
        arch = smoke_config(name)
        params = model_lib.init_params(arch, torch.Generator().manual_seed(0),
                                       "cpu", torch.float32)
        jparams = jax.eval_shape(
            lambda m=build_model(jax_smoke_config(name)): m.init(
                jax.random.key(0)))
        with jsh.activate(mesh, jsh.make_rules(**kw)):
            jspecs = jsh.param_pspecs(jparams)
        specs = sh.param_pspecs(params, sh.make_rules(**kw))
        stacks = {k: len(params[k]) for k in zero.STACKS
                  if isinstance(params.get(k), list)}
        for (path, sp), (_, leaf) in zip(zero.leaf_paths(specs),
                                         zero.leaf_paths(params)):
            jpath, _ = zero.jax_path(path, stacks, period_length(arch))
            node, jleaf = jspecs, jparams
            for k in jpath:
                node, jleaf = node[str(k)], jleaf[str(k)]
            want = tuple(node)
            want = want + (None,) * (jleaf.ndim - len(want))
            pad = len(want) - len(sp)
            assert want[:pad] == (None,) * pad and want[pad:] == sp, (
                name, path, sp, want)
            got = sh.sanitize_spec(sp, leaf.shape, sizes)
            jgot = tuple(jsh._sanitize(node, jleaf.shape, sizes))
            jgot = jgot + (None,) * (jleaf.ndim - len(jgot))
            assert jgot[pad:] == got, (name, path, got, jgot)


SANITIZE_CASES = [
    (("data", None), (1, 16), {"data": 16, "model": 16}),
    (("data",), (7,), {"data": 16, "model": 16}),
    (("data", "model"), (32, 32), {"data": 16, "model": 16}),
    ((("data", "model"),), (16,), {"data": 16, "model": 16}),
    (("model",), (8, 12), {"data": 8, "model": 4}),
    (("data", "model"), (7, 12), {"data": 8, "model": 4}),
    ((("data", "model"),), (8,), {"data": 8, "model": 4}),
    ((("model", "data"),), (8,), {"data": 8, "model": 4}),
    ((None, "model"), (3, 5), {"data": 8, "model": 4}),
    (("model",), (5,), {"model": 1}),
]


@pytest.mark.parametrize("case", range(len(SANITIZE_CASES)))
def test_sanitize_is_jax(case):
    """``_sanitize`` on JAX's own cases (``tests/test_sharding.py``) gives
    JAX's specs; ``sanitize_spec`` with no mesh is the identity."""
    from jax.sharding import PartitionSpec as P
    from repro.parallel import sharding as jsh
    from repro_torch.parallel import sharding as sh
    spec, shape, sizes = SANITIZE_CASES[case]
    want = tuple(jsh._sanitize(P(*spec), shape, sizes))
    want = want + (None,) * (len(shape) - len(want))
    assert sh._sanitize(spec, shape, sizes) == want
    assert sh.sanitize_spec(spec, shape, None) == spec
