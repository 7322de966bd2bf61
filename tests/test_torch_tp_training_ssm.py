"""mamba2-1.3b (the ssm family) on a (2, 2) mesh of gloo ranks in the port
against the JAX package's single-device ``zero1=True`` step, through the
checks of ``tests/test_torch_tp_training.py`` (smoke size in float32, B4 /
S32, two steps; the loss within 1e-5 relative and ``grad_norm`` within
1e-4 relative of JAX's, the assembled params and LAMB state within
``_assert_trees_close``, every rank's blocks, the collectives a step
against ``zero_collectives``): at ``make_rules()``'s defaults through the
kernels' path at M 1 and plain at M 2, and with ``seq_parallel=False``,
where ``A_log``, ``D``, ``dt_bias`` and ``norm_scale`` (whole on every
rank, each rank touching its heads' entries) still need their model-axis
gradient sum. Each rank runs its 8 of the 16 SSD heads and 8 of the 16 B
and C columns.
"""
import pytest

from test_torch_tp_training import (check_blocks, check_collectives,
                                    check_metrics, check_state, ids, runs)

CASES = [("mamba2-1.3b", 1, "lamb", True, {}),
         ("mamba2-1.3b", 2, "lamb", False, {}),
         ("mamba2-1.3b", 2, "lamb", False, {"seq_parallel": False})]
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
