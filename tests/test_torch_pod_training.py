"""Training on a (pod, data, model) mesh under ``make_rules(multi_pod=
True)`` in the port against the JAX package's single-device ``zero1=True``
step: four gloo ranks as (2, 2, 1) and as (2, 1, 2), smoke size in
float32, B4 / S32 at M 1 (a row a rank at (2, 2, 1)), two steps,
bert-large through the kernels' path, llama3.2-3b and mamba2-1.3b plain.
The batch rows split over
(pod, data), pod-major; the ZeRO layout stays within a pod, each rank's
reduced shard all-reduced over the pod axis. Besides the checks of
``tests/test_torch_tp_training.py`` (loss, ``grad_norm`` and accuracy
against JAX's; the assembled params and LAMB state; each rank's blocks;
the collectives a step against ``zero_collectives``, the pod's all-reduce
included), the ranks that differ only in their pod hold bitwise equal
ZeRO shards of ``m``, ``v`` and ``master``: the pods take the same
steps, and a norm summed over both pods (twice the squares) would show
in ``grad_norm``.
"""
import numpy as np
import pytest

from test_torch_tp_training import (check_blocks, check_collectives,
                                    check_metrics, check_state, ids, runs)

CASES = [("bert-large", 1, "lamb", True, {"multi_pod": True}),
         ("llama3.2-3b", 1, "lamb", False, {"multi_pod": True}),
         ("mamba2-1.3b", 1, "lamb", False, {"multi_pod": True})]
MESHES = [(2, 2, 1), (2, 1, 2)]
_CACHES = {m: {} for m in MESHES}
_JAX = {}


def _jax_shared(case, name):
    """One JAX run a case for both meshes."""
    from test_torch_dp_training import _jax_run
    key = (name, case["shape"]["microbatches"], case["run"]["optimizer"],
           case["run"]["fused_optimizer_kernel"])
    if key not in _JAX:
        _JAX[key] = _jax_run(case, name)
    return _JAX[key]


def _runs(shape):
    return runs(CASES, shape, _CACHES[shape], _jax_shared)


PARAMS = [(m, i) for m in MESHES for i in range(len(CASES))]
IDS = ["x".join(map(str, m)) + "-" + n for m in MESHES for n in ids(CASES)]


@pytest.mark.parametrize("shape,i", PARAMS, ids=IDS)
def test_metrics_match_jax(shape, i):
    _, ranks, jax_out = _runs(shape)
    check_metrics([r[i] for r in ranks], jax_out[i][0])


@pytest.mark.parametrize("shape,i", PARAMS, ids=IDS)
def test_state_matches_jax(shape, i):
    made, ranks, jax_out = _runs(shape)
    check_state(made[i], CASES[i][2], [r[i] for r in ranks], jax_out[i])


@pytest.mark.parametrize("shape,i", PARAMS, ids=IDS)
def test_ranks_hold_their_blocks(shape, i):
    made, ranks, _ = _runs(shape)
    check_blocks(made[i], CASES[i][4], [r[i] for r in ranks])


@pytest.mark.parametrize("shape,i", PARAMS, ids=IDS)
def test_collectives_a_step_are_the_stated_ones(shape, i):
    _, ranks, _ = _runs(shape)
    got = [r[i] for r in ranks]
    check_collectives(got)
    assert all(r["stated"]["all_reduce"] > 0 for r in got)


@pytest.mark.parametrize("shape,i", PARAMS, ids=IDS)
def test_pods_hold_bitwise_equal_shards(shape, i):
    _, ranks, _ = _runs(shape)
    got = [r[i] for r in ranks]
    assert {r["coords"]["pod"] for r in got} == {0, 1}
    seen = {}
    for r in got:
        key = (r["coords"]["data"], r["coords"]["model"])
        if key not in seen:
            seen[key] = r
            continue
        first = seen[key]
        assert first["coords"]["pod"] != r["coords"]["pod"]
        for k, shards in r["shards"].items():
            for a, b in zip(shards, first["shards"][k]):
                np.testing.assert_array_equal(a, b, err_msg=k)
    assert len(seen) == 2
