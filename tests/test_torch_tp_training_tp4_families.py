"""mamba2-1.3b and whisper-base on a (1, 4) mesh (a model axis of four
gloo ranks) in the port against the JAX package's single-device
``zero1=True`` step, through the checks of
``tests/test_torch_tp_training.py``: mamba2's smoke mixer has 16 SSD
heads and 16 B and C columns, 4 of each a rank (the B and C gathered
from four ranks); whisper's 2 KV heads are fewer than the 4 model ranks,
so each rank holds half a KV head's columns, in the self-attention's
fused ``wqkv`` and in the cross-attention's ``wk`` / ``wv``, and gathers
the head its queries read. A file of its own, so that xdist runs it
beside the (2, 2) files.
"""
import pytest

from test_torch_tp_training import (check_blocks, check_collectives,
                                    check_metrics, check_state, ids, runs)

CASES = [("mamba2-1.3b", 2, "lamb", False, {}),
         ("whisper-base", 1, "lamb", True, {})]
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
