"""Training on a (1, 4) mesh (a model axis of four gloo ranks) in the port
against the JAX package's single-device ``zero1=True`` step, through the
checks of ``tests/test_torch_tp_training.py``: internlm2-1.8b smoke, whose
2 KV heads are fewer than the 4 model ranks (each rank holds half a KV
head's columns and gathers the head its queries read), and
deepseek-moe-16b smoke, its 4 experts one a rank. A file of its own, so
that xdist runs it beside the (2, 2) file.
"""
import pytest

from test_torch_tp_training import (check_blocks, check_collectives,
                                    check_metrics, check_state, ids, runs)

CASES = [("internlm2-1.8b", 2, "lamb", False, {}),
         ("deepseek-moe-16b", 1, "lamb", True, {})]
_CACHE = {}


def _runs():
    return runs(CASES, (1, 4), _CACHE)


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
