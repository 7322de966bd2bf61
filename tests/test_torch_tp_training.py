"""Training on a (data, model) mesh in the port against the JAX package's
single-device ``zero1=True`` step: four gloo ranks on the CPU as a (2, 2)
mesh (``launch.mesh.spawn``; one spawn runs every case, each rank training
each case in turn through ``build_train_step(run, mesh=mesh, rules=...)``),
torch at one thread a rank, smoke size in float32, B4 / S32, two steps from
the port's seeded init on the synthetic pipeline's batches:

- at ``make_rules()``'s defaults (tensor, sequence and expert parallelism
  and FSDP): bert-large, llama3.2-3b, internlm2-1.8b, deepseek-moe-16b and
  qwen2-vl-2b, at M 1 through the kernels' path (the LAMB kernels and
  ``REPRO_FUSED_BLOCKS=1``, their plain versions on the CPU) and at M 2
  plain;
- llama3.2-3b with ``seq_parallel=False``, with ``fsdp=False`` and under
  AdamW; deepseek-moe-16b with ``expert_parallel=False``.

Each case holds:

- the loss within 1e-5 relative and ``grad_norm`` within 1e-4 relative of
  JAX's at both steps, every rank's metrics equal;
- the params and LAMB's ``m``, ``v`` and ``master`` (AdamW's ``m`` and
  ``v``), assembled from the ranks' blocks (``convert.assemble``), within
  ``_assert_trees_close`` of JAX's (the optimizer state in JAX's flat
  layout, padding included);
- every rank's leaf shapes those of its block under the sanitized
  ``param_pspecs``, and the ranks that hold the same block of a leaf hold
  the same bits;
- the collectives a step by kind equal ``zero_collectives``.

``tests/test_torch_tp_training_tp4.py`` runs the (1, 4) mesh through the
same checks. The JAX steps are computed while the ranks train.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch import tree
from repro_torch.launch import mesh
from repro_torch.models import transformer as tf
from repro_torch.models.convert import assemble, to_jax_layout
from repro_torch.optim import zero
from repro_torch.parallel import sharding
from test_torch_dp_training import _case, _jax_run
from test_torch_training import _assert_trees_close

torch.set_num_threads(2)

STEPS = 2
# (arch, micro-batches, optimizer, the kernels' path, make_rules keywords)
CASES = [(name, m, "lamb", m == 1, {})
         for name in ("bert-large", "llama3.2-3b", "internlm2-1.8b",
                      "deepseek-moe-16b", "qwen2-vl-2b") for m in (1, 2)] \
    + [("llama3.2-3b", 2, "lamb", False, {"seq_parallel": False}),
       ("llama3.2-3b", 2, "lamb", False, {"fsdp": False}),
       ("llama3.2-3b", 2, "adamw", False, {}),
       ("deepseek-moe-16b", 2, "lamb", False, {"expert_parallel": False})]
_CACHE = {}


def ids(cases):
    return [f"{n}-M{m}-{o}{'-fused' if f else ''}"
            + "".join(f"-{k}={v}" for k, v in r.items())
            for n, m, o, f, r in cases]


def runs(cases, shape, cache, jax_run=_jax_run):
    """(every rank's results, JAX's) for every case on a mesh of
    ``shape``: (data, model), or (pod, data, model) for three sizes;
    made once a ``cache``. Cases that differ only in their rules share
    one JAX run (JAX's single-device step does not read them)."""
    if "runs" not in cache:
        made = []
        for name, micro, opt, fused, rules in cases:
            case = _case(name, micro, opt, fused)
            case.update(rules=rules, fused_blocks=fused)
            made.append(case)
        axes = ("data", "model") if len(shape) == 2 \
            else ("pod", "data", "model")
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            ranks = ex.submit(
                mesh.spawn, torch_ranks.tp_train_cases, int(np.prod(shape)),
                made, STEPS, backend="gloo", device="cpu",
                mesh=(shape, axes), timeout=600)
            seen, jax_out = {}, []
            for case, c in zip(made, cases):
                key = c[:4]
                if key not in seen:
                    seen[key] = jax_run(case, c[0])
                jax_out.append(seen[key])
            cache["runs"] = (made, ranks.result(), jax_out)
    return cache["runs"]


def check_metrics(got_ranks, want):
    lead = got_ranks[0]["metrics"]
    for r in got_ranks[1:]:
        assert r["metrics"] == lead
    for got, exp in zip(lead, want):
        np.testing.assert_allclose(got["loss"], exp["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], exp["grad_norm"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["accuracy"], exp["accuracy"],
                                   atol=1e-6)
    assert lead[1]["loss"] != lead[0]["loss"]


def _whole(case, got_ranks, key, sub=None):
    trees = [r[key] if sub is None else r[key][sub] for r in got_ranks]
    first = got_ranks[0]
    return assemble(trees, [r["coords"] for r in got_ranks], first["specs"],
                    case["arch"], first["sizes"])


def check_state(case, opt, got_ranks, jax_out):
    """The assembled params and optimizer state against JAX's."""
    want, loose = jax_out[1], jax_out[2]
    arch = case["arch"]
    period = tf.period_length(arch)
    params = _whole(case, got_ranks, "params")
    _assert_trees_close(to_jax_layout(params, period), want["params"],
                        "params", loose)
    keys = ("m", "v", "master") if opt == "lamb" else ("m", "v")
    assert sorted(got_ranks[0]["opt"]) == sorted(keys)
    plan = zero.Plan(params, period=period, layer_rows=opt == "lamb")
    for k in keys:
        whole = _whole(case, got_ranks, "opt", k)
        flat = zero.to_jax_layout(plan.state(plan.shards(whole)), plan)
        _assert_trees_close(flat, want["opt"][k], k)


def check_blocks(case, rules, got_ranks):
    """Each rank's leaves are its blocks under the sanitized specs, and
    the ranks holding the same block hold the same bits."""
    sizes = got_ranks[0]["sizes"]
    whole = tree.map(torch.from_numpy, case["params"])
    specs = sharding.sanitize_tree(
        sharding.param_pspecs(whole, sharding.make_rules(**rules)), whole,
        sizes)
    assert got_ranks[0]["specs"] == specs
    cut = [sharding.leaf_items(sharding.train_blocks(
        whole, specs, case["arch"], sizes, r["coords"]))
           for r in got_ranks]
    for j, (path, sp) in enumerate(sharding.leaf_items(specs)):
        axes = sorted({a for e in sp for a in sharding._axes(e)})
        seen = {}
        for r, mine in zip(got_ranks, cut):
            block = sharding.leaf_items(r["params"])[j][1]
            want = tuple(mine[j][1].shape)
            assert block.shape == want, (path, block.shape, want)
            key = tuple(r["coords"][a] for a in axes)
            if key in seen:
                np.testing.assert_array_equal(block, seen[key],
                                              err_msg="/".join(path))
            seen[key] = block


def check_collectives(got_ranks):
    for r in got_ranks:
        assert r["counts"] == [r["stated"]] * STEPS


def _runs():
    return runs(CASES, (2, 2), _CACHE)


@pytest.mark.parametrize("i", range(len(CASES)), ids=ids(CASES))
def test_metrics_match_jax(i):
    _, ranks, jax_out = _runs()
    check_metrics([r[i] for r in ranks], jax_out[i][0])


@pytest.mark.parametrize("i", range(len(CASES)), ids=ids(CASES))
def test_state_matches_jax(i):
    made, ranks, jax_out = _runs()
    check_state(made[i], CASES[i][2], [r[i] for r in ranks], jax_out[i])


@pytest.mark.parametrize("i", range(len(CASES)), ids=ids(CASES))
def test_ranks_hold_their_blocks(i):
    made, ranks, _ = _runs()
    check_blocks(made[i], CASES[i][4], [r[i] for r in ranks])


@pytest.mark.parametrize("i", range(len(CASES)), ids=ids(CASES))
def test_collectives_a_step_are_the_stated_ones(i):
    _, ranks, _ = _runs()
    check_collectives([r[i] for r in ranks])
