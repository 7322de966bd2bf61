"""jamba-v0.1-52b (the hybrid family) on a (2, 2) mesh of gloo ranks in
the port against the JAX package's single-device ``zero1=True`` step,
through the checks of ``tests/test_torch_tp_training.py`` (smoke size in
float32, B4 / S32, two steps), at ``make_rules()``'s defaults through the
kernels' path at M 1 and plain at M 2. One period of 8 layers: seven
mamba mixers on their ranks' heads, one attention layer (index 4: 4 query
and 2 KV heads, one KV head a rank), and a MoE tail every other layer
(4 experts, 2 a rank), the rest MLPs; ``zero_collectives`` counts each
kind of layer by ``layer_kinds``.
"""
import pytest

from test_torch_tp_training import (check_blocks, check_collectives,
                                    check_metrics, check_state, ids, runs)

CASES = [("jamba-v0.1-52b", 1, "lamb", True, {}),
         ("jamba-v0.1-52b", 2, "lamb", False, {})]
_CACHE = {}


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
