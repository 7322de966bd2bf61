"""Data-parallel ZeRO-1 training in the port against the JAX package's
single-device ``zero1=True`` step: two gloo ranks on the CPU, one process
each (``launch.mesh.spawn`` with a ("data", "model") mesh of 2 x 1; one
spawn runs every case, each rank training each case in turn through
``build_train_step(run, mesh=mesh)``), smoke size in float32, B4 / S32,
from the port's seeded init, two steps on the synthetic pipeline's batches
(MLM for bert-large, whose masks differ from row to row; causal
otherwise), LAMB through the kernels' path at M 1 and plain at M 2, and
AdamW once:

- the loss within 1e-5 relative and ``grad_norm`` within 1e-4 relative of
  JAX's at both steps (the masked mean over the whole batch's count, the
  MoE's Switch loss over the whole batch); every rank's metrics equal;
- the parameters bitwise equal across the ranks and within
  ``_assert_trees_close``'s tolerances of JAX's; rank r's ``m``, ``v`` and
  ``master`` are its columns of JAX's flat leaves (``[r P / 2, (r + 1) P
  / 2)``), held the same way (AdamW's params, where JAX's first gradient
  is below 1e-7, within 1e-2, as ``tests/test_torch_training.py`` holds
  them);
- the collectives a step by kind equal ``zero_collectives``;
- ``train_loop`` with the data group logs and keeps history on rank 0
  only;
- what a mesh's step still refuses: an ssm arch on a model axis of 2 and
  a pod axis of 2 (``tests/test_torch_tp_training.py`` trains the model
  axis), and a dp that does not divide 256.

The JAX steps are computed while the ranks train (the spawn runs in a
thread).
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.configs import RunConfig as JaxRunConfig
from repro.configs import ShapeConfig as JaxShapeConfig
from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train.steps import build_train_step as jax_build_train_step
from repro_torch import tree
from repro_torch.configs import RunConfig, ShapeConfig, smoke_config
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.launch import mesh
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tf
from repro_torch.models.convert import to_jax_layout
from repro_torch.train.steps import build_train_step
from test_torch_training import _assert_trees_close

torch.set_num_threads(2)

B, S, STEPS, DP = 4, 32, 2, 2
# (arch, micro-batches, optimizer, the LAMB kernels' path)
CASES = [(name, m, "lamb", m == 1)
         for name in ("bert-large", "llama3.2-3b", "deepseek-moe-16b",
                      "mamba2-1.3b") for m in (1, 2)] \
    + [("llama3.2-3b", 2, "adamw", False)]
IDS = [f"{n}-M{m}-{o}{'-fused' if f else ''}" for n, m, o, f in CASES]
_CACHE = {}


def _fp32(arch, **kw):
    return dataclasses.replace(arch, dtype="float32", param_dtype="float32",
                               **kw)


def _case(name, micro, opt, fused):
    t_arch = _fp32(smoke_config(name))
    params = tree.map(lambda t: t.numpy(), model_lib.init_params(
        t_arch, torch.Generator().manual_seed(0), "cpu", torch.float32))
    data = SyntheticPipeline(DataConfig(
        vocab_size=t_arch.vocab_size, seq_len=S, global_batch=B,
        objective="mlm" if t_arch.bidirectional else "causal", seed=1))
    return {"arch": t_arch, "params": params,
            "shape": dict(name="t", seq_len=S, global_batch=B, kind="train",
                          microbatches=micro),
            "run": dict(optimizer=opt, learning_rate=1e-3, zero1=True,
                        fused_optimizer_kernel=fused),
            "batches": [data.batch(i) for i in range(STEPS)]}


def _jax_run(case, name):
    """JAX's single-device zero1 step from the same weights: the metrics a
    step, the final state (numpy) and, for AdamW, where the first
    gradient is below 1e-7 (``tests/test_torch_training.py``'s exception:
    AdamW's first step there is g / (|g| + eps), which turns fp32 rounding
    noise in g into O(1) differences of the step direction). JAX's blocks
    do not recompute (it compiles faster; no value changes)."""
    j_arch = _fp32(jax_smoke_config(name), remat=False)
    run = JaxRunConfig(arch=j_arch, shape=JaxShapeConfig(**case["shape"]),
                       **case["run"])
    p = jax.tree.map(jnp.asarray, to_jax_layout(
        tree.map(torch.from_numpy, case["params"]),
        tf.period_length(case["arch"])))
    state = {"opt": jax_make_optimizer(run).init(p), "params": p}
    loose = None
    if run.optimizer == "adamw":
        first = {k: jnp.asarray(v) for k, v in case["batches"][0].items()}
        g0 = jax.grad(lambda q: build_model(j_arch).loss(q, first)[0])(p)
        loose = jax.tree.map(lambda g: np.abs(np.asarray(g)) < 1e-7, g0)
    step = jax.jit(jax_build_train_step(run).fn)
    metrics = []
    for b in case["batches"]:
        state, met = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in met.items()})
    return metrics, jax.tree.map(np.asarray, state), loose


def _runs():
    """(every rank's results, JAX's) for every case, made once."""
    if "runs" not in _CACHE:
        cases = [_case(*c) for c in CASES]
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            ranks = ex.submit(
                mesh.spawn, torch_ranks.train_cases, DP, cases, STEPS,
                backend="gloo", device="cpu",
                mesh=((DP, 1), ("data", "model")), timeout=600)
            jax_out = [_jax_run(case, c[0]) for case, c in zip(cases, CASES)]
            _CACHE["runs"] = (ranks.result(), jax_out)
    return _CACHE["runs"]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_metrics_match_jax(i):
    ranks, jax_out = _runs()
    want = jax_out[i][0]
    lead = ranks[0]["cases"][i]["metrics"]
    for r in ranks[1:]:
        assert r["cases"][i]["metrics"] == lead
    for got, exp in zip(lead, want):
        np.testing.assert_allclose(got["loss"], exp["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], exp["grad_norm"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["accuracy"], exp["accuracy"],
                                   atol=1e-6)
    assert lead[1]["loss"] != lead[0]["loss"]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_state_matches_jax_and_ranks_hold_their_columns(i):
    ranks, jax_out = _runs()
    want = jax_out[i][1]
    lead = ranks[0]["cases"][i]
    for r in ranks[1:]:
        for a, b in zip(jax.tree.leaves(r["cases"][i]["params"]),
                        jax.tree.leaves(lead["params"])):
            np.testing.assert_array_equal(a, b)
    _assert_trees_close(lead["params"], want["params"], "params",
                        jax_out[i][2])
    keys = ("m", "v", "master") if CASES[i][2] == "lamb" else ("m", "v")
    for rank, r in enumerate(ranks):
        got = r["cases"][i]
        assert got["rank"] == rank and got["dp"] == DP
        assert sorted(got["opt"]) == sorted(keys)
        for k in keys:
            cols = jax.tree.map(
                lambda a: a[..., rank * a.shape[-1] // DP:
                            (rank + 1) * a.shape[-1] // DP], want["opt"][k])
            _assert_trees_close(got["opt"][k], cols, f"rank {rank} {k}")


def test_collectives_a_step_are_the_stated_ones():
    ranks, _ = _runs()
    for r in ranks:
        for case in r["cases"]:
            assert case["counts"] == [case["stated"]] * STEPS
    moe = ranks[0]["cases"][IDS.index("deepseek-moe-16b-M2-lamb")]
    assert moe["stated"]["all_reduce"] > ranks[0]["cases"][0]["stated"][
        "all_reduce"]


def test_train_loop_logs_on_rank_0_only():
    ranks, _ = _runs()
    assert ranks[0]["loop"] == {"history": 2, "logs": 2}
    assert ranks[1]["loop"] == {"history": 0, "logs": 0}


def test_model_axis_is_refused():
    """The model axis trains the dense, moe and vlm families; an ssm arch
    on it and a pod axis are refused, naming what is missing."""
    ranks, _ = _runs()
    for r in ranks:
        ssm = r["refusals"]["ssm model axis"]
        assert ssm is not None and "model axis of 2" in ssm \
            and "per-segment split" in ssm
        pod = r["refusals"]["pod axis"]
        assert pod is not None and "pod axis" in pod and "'pod': 2" in pod


class _Mesh:
    """A stand-in for a mesh of three ranks on the data axis: the dp check
    comes before any collective."""
    mesh_dim_names = ("data",)
    shape = (3,)

    def get_coordinate(self):
        return [0]

    def get_group(self, name):
        return None


def test_dp_not_dividing_256_is_refused():
    arch = _fp32(smoke_config("llama3.2-3b"))
    bundle = build_train_step(RunConfig(arch=arch, shape=ShapeConfig(
        "t", S, 6, "train")), device="cpu", mesh=_Mesh())
    with pytest.raises(ValueError, match="dp=3 does not divide the ZeRO pad "
                                         "multiple 256"):
        bundle.init(0)
