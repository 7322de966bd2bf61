"""whisper-base (the encdec family) on a (2, 2) mesh of gloo ranks in the
port against the JAX package's single-device ``zero1=True`` step, through
the checks of ``tests/test_torch_tp_training.py`` (smoke size in float32,
B4 / S32, two steps, the synthetic pipeline's frame embeddings [B, 16,
D]), at ``make_rules()``'s defaults through the kernels' path at M 1 and
plain at M 2, and with ``fsdp=False``. The encoder's residual stream is
a rank's 8 of the 16 frames (its own sinusoidal rows), its blocks the
rank's heads and MLP columns; a decoder block's cross-attention runs the
rank's heads over the whole encoder output, gathered once; the tied head
is vocab-parallel.
"""
import pytest

from test_torch_tp_training import (check_blocks, check_collectives,
                                    check_metrics, check_state, ids, runs)

CASES = [("whisper-base", 1, "lamb", True, {}),
         ("whisper-base", 2, "lamb", False, {}),
         ("whisper-base", 2, "lamb", False, {"fsdp": False})]
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
