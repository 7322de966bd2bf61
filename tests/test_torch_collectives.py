"""The port's ``parallel.collectives`` and ``parallel.pipeline`` and the
meshes of ``launch.mesh``, against the JAX package's
``tests/test_collectives.py`` and ``tests/test_pipeline.py``:

- ``quantize_int8`` bitwise JAX's on the same numpy input, exact .5 ties
  (round half to even) and clipping included; the error-feedback
  round trip within half a step;
- on 8 gloo ranks on the CPU (one spawn, a ("pod", "data") mesh of 2 x 4,
  each rank's gradient x (1 + data index + 10 pod index)):
  ``compressed_psum`` over data is 2.5 x within 10 scale + 0.05 in pod 0,
  ``hierarchical_psum`` 60 x within 1e-3 on every rank; a GPipe pipeline
  of S 4 stages over each pod's data group, M 8 micro-batches of a
  [16, 32] batch, equals the sequential stages on the same numpy weights
  within 1e-6 on every rank; ``make_mesh`` lays rank r at row-major
  position r with one group a line of each axis;
- ``bubble_fraction`` is JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.parallel import collectives as JC
from repro.parallel.pipeline import bubble_fraction as jax_bubble
from repro_torch.launch import mesh
from repro_torch.parallel import collectives as C
from repro_torch.parallel.pipeline import bubble_fraction

torch.set_num_threads(2)

POD, DATA, STAGES, MICRO = 2, 4, 4, 8
_CACHE = {}


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=256).astype(np.float32)
    pipe_x = rng.normal(size=(16, 32)).astype(np.float32)
    ws = (0.3 * rng.normal(size=(STAGES, 32, 32))).astype(np.float32)
    return x, pipe_x, ws


def _ranks():
    if "ranks" not in _CACHE:
        x, pipe_x, ws = _inputs()
        _CACHE["ranks"] = mesh.spawn(
            torch_ranks.collective_cases, POD * DATA, x, pipe_x, ws, MICRO,
            backend="gloo", device="cpu", mesh=((POD, DATA), ("pod", "data")),
            timeout=300)
    return _CACHE["ranks"]


@pytest.mark.parametrize("scale", [1.0, 3.0, 1e-3])
def test_quantize_int8_bitwise_jax(scale):
    rng = np.random.default_rng(int(scale * 1000))
    x = (scale * rng.normal(size=1024)).astype(np.float32)
    q, s = C.quantize_int8(torch.from_numpy(x))
    jq, js = JC.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    np.testing.assert_array_equal(
        C.dequantize_int8(q, s).numpy(),
        np.asarray(JC.dequantize_int8(jq, js)))


def test_quantize_rounds_ties_to_even_as_jax():
    """x / scale exactly k + 0.5 (scale 1: max |x| 127): half to even."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -127.0,
                  3.49, 3.5], np.float32)
    q, s = C.quantize_int8(torch.from_numpy(x))
    jq, js = JC.quantize_int8(jnp.asarray(x))
    assert s.item() == float(js) == 1.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -127, 3, 4]


def test_error_feedback_round_trip():
    x = torch.from_numpy(3.0 * np.random.default_rng(1).normal(
        size=512).astype(np.float32))
    q, s = C.quantize_int8(x)
    assert (C.dequantize_int8(q, s) - x).abs().max() <= s * 0.5 + 1e-6


def test_compressed_psum_is_the_mean_over_data():
    x, _, _ = _inputs()
    scale = 4 * np.abs(x).max() / 127.0
    for r in _ranks():
        if r["coords"]["pod"] == 0:
            assert np.abs(r["y"] - 2.5 * x).max() < 10 * scale + 0.05
        local = x * (1.0 + r["coords"]["data"] + 10.0 * r["coords"]["pod"])
        q, s = JC.quantize_int8(jnp.asarray(local))
        np.testing.assert_allclose(
            r["err"], local - np.asarray(JC.dequantize_int8(q, s)),
            atol=1e-6)


def test_hierarchical_psum_is_the_sum_over_every_rank():
    x, _, _ = _inputs()
    for r in _ranks():
        np.testing.assert_allclose(r["h"], 60.0 * x, rtol=1e-3, atol=1e-3)


def test_pipeline_matches_sequential_stages():
    _, pipe_x, ws = _inputs()
    ref = pipe_x
    for s in range(STAGES):
        ref = np.tanh(ref @ ws[s])
    for r in _ranks():
        assert np.abs(r["pipe"] - ref).max() < 1e-6


def test_mesh_lays_ranks_out_row_major():
    for rank, r in enumerate(_ranks()):
        pod, data = rank // DATA, rank % DATA
        assert r["coords"] == {"pod": pod, "data": data}
        assert r["groups"] == {
            "data": [pod * DATA + d for d in range(DATA)],
            "pod": [p * DATA + data for p in range(POD)]}


def test_bubble_fraction_is_jax():
    for s, m in ((4, 4), (1, 8), (4, 28), (4, 8), (8, 3)):
        assert bubble_fraction(s, m) == jax_bubble(s, m)
    assert bubble_fraction(4, 4) == 3 / 7
