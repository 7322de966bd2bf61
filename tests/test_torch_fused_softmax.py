"""The fused scale + causal mask + softmax: the port's plain version against
the JAX reference and against the Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it) on the same numpy inputs, fp32 within
1e-6 (rows summing to 1 within 1e-5) and bf16 within 1 bf16 ulp of each
JAX output; ragged Sq, which the Pallas kernel rejects, against the JAX
reference; the wrapper's contract and CPU dispatch; bf16 outputs held to a
float64 softmax; and, on a card only, the CUDA kernel against the plain
version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_softmax import kernel as jkernel
from repro.kernels.fused_softmax import ops as jops
from repro.kernels.fused_softmax import ref as jref
from repro_torch.kernels.fused_softmax import ops, ref

torch.set_num_threads(2)

ATOL = 1e-6
SCALE = 0.125
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}

# name: (shape, causal, q_offset); Sq a multiple of min(128, Sq), as the
# Pallas kernel needs; q_offset -1 leaves row 0 with no valid column
CASES = {
    "full": ((4, 128, 128), False, 0),
    "causal": ((4, 128, 128), True, 0),
    "offset64": ((2, 256, 192), True, 64),
    "offset-1": ((3, 128, 160), True, -1),
    "4d": ((2, 3, 128, 96), True, 0),
}


def _scores(seed, shape, spread=3.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * spread).astype(np.float32)


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp (8 significant bits) at each |a|."""
    top = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(top)) - 7)


def _port(s, dtype, **kw):
    return ops.scale_mask_softmax(torch.from_numpy(s).to(dtype),
                                  **kw).float().numpy()


def _assert_close(got, want, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5, rtol=0)
    else:
        err = np.abs(got - want)
        assert (err <= _bf16_ulp(want)).all(), float(
            (err / _bf16_ulp(want)).max())


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_ref(case, dt):
    shape, causal, off = CASES[case]
    tdt, jdt = DTYPES[dt]
    s = _scores(1, shape)
    kw = dict(scale=SCALE, causal=causal, q_offset=off)
    want = np.asarray(jref.scale_mask_softmax(jnp.asarray(s, jdt), **kw)
                      .astype(jnp.float32))
    _assert_close(_port(s, tdt, **kw), want, tdt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret(case, dt):
    """N-D scores go through both wrappers' reshape to [N, Sq, Sk]."""
    shape, causal, off = CASES[case]
    tdt, jdt = DTYPES[dt]
    s = _scores(2, shape)
    kw = dict(scale=SCALE, causal=causal, q_offset=off)
    want = np.asarray(jops.scale_mask_softmax(jnp.asarray(s, jdt),
                                              interpret=True, **kw)
                      .astype(jnp.float32))
    _assert_close(_port(s, tdt, **kw), want, tdt)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_fully_masked_row_is_uniform(dt):
    """With q_offset -1 row 0 has no valid column: the finite -1e30 mask
    gives it 1 / Sk, as the JAX reference does; every other masked entry
    is exactly 0."""
    tdt, _ = DTYPES[dt]
    sq, sk = 16, 40
    s = torch.from_numpy(_scores(3, (2, sq, sk))).to(tdt)
    y = ops.scale_mask_softmax(s, scale=SCALE, causal=True, q_offset=-1)
    assert torch.equal(y[:, 0], torch.full((2, sk), 1.0 / sk).to(tdt))
    masked = torch.arange(sk)[None] > torch.arange(sq)[:, None] - 1
    masked[0] = False
    assert (y[:, masked] == 0).all()
    assert (y[:, 1:][~masked[1:].expand(2, -1, -1)] > 0).all()


@pytest.mark.parametrize("causal", [True, False])
def test_plain_takes_a_ragged_sq(causal):
    """Sq 200, not a multiple of the Pallas kernel's 128-row tile: against
    the JAX reference only (the kernel asserts, see below)."""
    s = _scores(4, (3, 200, 200))
    kw = dict(scale=SCALE, causal=causal, q_offset=0)
    want = np.asarray(jref.scale_mask_softmax(jnp.asarray(s), **kw))
    _assert_close(_port(s, torch.float32, **kw), want, torch.float32)


def test_jax_softmax_kernel_asserts_on_a_ragged_length():
    """A fault of the reference: the Pallas kernel asserts
    ``sq % min(128, sq) == 0`` and ``ops.scale_mask_softmax`` passes the
    shape through unpadded, so on a TPU a ragged Sq fails there. The port
    takes any Sq (``test_plain_takes_a_ragged_sq``)."""
    s = jnp.asarray(_scores(5, (2, 200, 200)))
    with pytest.raises(AssertionError):
        jkernel.scale_mask_softmax(s, scale=SCALE, causal=True,
                                   interpret=True)
    with pytest.raises(AssertionError):
        jops.scale_mask_softmax(s, scale=SCALE, causal=True, interpret=True)


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    s = torch.from_numpy(_scores(6, (2, 4, 64, 80)))
    ops.LAUNCHES["scale_mask_softmax"] = 0
    out = ops.scale_mask_softmax(s, scale=SCALE, causal=True, q_offset=16)
    plain = ref.scale_mask_softmax(s, scale=SCALE, causal=True, q_offset=16)
    assert torch.equal(out, plain) and out.shape == s.shape
    assert ops.LAUNCHES["scale_mask_softmax"] == 0


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    s = torch.from_numpy(_scores(7, (2, 32, 48)))
    kw = dict(scale=SCALE, causal=True)
    for bad in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            ops.scale_mask_softmax(s.to(bad), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ops.scale_mask_softmax(s.transpose(1, 2), **kw)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.scale_mask_softmax(s.clone().requires_grad_(), **kw)
    with torch.no_grad():
        ops.scale_mask_softmax(s.clone().requires_grad_(), **kw)


def _softmax_f64(s: torch.Tensor, causal: bool, q_offset: int) -> np.ndarray:
    x = s.double() * SCALE
    if causal:
        sq, sk = s.shape[-2:]
        rows = torch.arange(sq)[:, None] + q_offset
        x = torch.where(torch.arange(sk)[None] <= rows, x, -1e30)
    p = torch.exp(x - x.amax(-1, keepdim=True))
    return (p / p.sum(-1, keepdim=True)).numpy()


@pytest.mark.parametrize("causal,off", [(False, 0), (True, 64)])
def test_bf16_outputs_are_rounded_from_the_float64_softmax(causal, off):
    """JAX's bf16 CPU reference and the port's plain version round some
    outputs to neighbouring bf16 values (seed 5 gives such elements in both
    cases). Against a float64 softmax both are within half a bf16 ulp plus
    the fp32 arithmetic's own error (2^-20 relative): the flips are
    near-ties of correctly computed fp32 values, not a fault of either."""
    s = torch.from_numpy(_scores(5, (4, 128, 256), spread=4.0)) \
        .to(torch.bfloat16)
    kw = dict(scale=SCALE, causal=causal, q_offset=off)
    port = ops.scale_mask_softmax(s, **kw).float().numpy()
    jx = np.asarray(jref.scale_mask_softmax(
        jnp.asarray(s.float().numpy()).astype(jnp.bfloat16), **kw)
        .astype(jnp.float32))
    truth = _softmax_f64(s, causal, off)
    assert (port != jx).any()
    tol = 0.5 * _bf16_ulp(truth) + 2.0 ** -20 * np.abs(truth)
    for got in (port, jx):
        assert (np.abs(got - truth) <= tol).all()


# ------------------------------------------------------------- on a card ----

@pytest.mark.gpu
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape,causal,off", [
    ((4, 128, 128), False, 0), ((3, 200, 200), True, 0),
    ((2, 64, 4096), True, 4032), ((2, 16, 40), True, -1),
    ((2, 16, 12288), False, 0)])
def test_kernel_matches_plain_on_card(shape, causal, off, dt):
    """fp32 within 2^-21 of each row's largest output, bf16 within 1 bf16
    ulp of the plain version run on the card; one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card (sm_90a)")
    tdt, _ = DTYPES[dt]
    s = torch.from_numpy(_scores(8, shape)).cuda().to(tdt)
    kw = dict(scale=SCALE, causal=causal, q_offset=off)
    n = ops.LAUNCHES["scale_mask_softmax"]
    out = ops.scale_mask_softmax(s, **kw)
    assert ops.LAUNCHES["scale_mask_softmax"] == n + 1
    plain = ref.scale_mask_softmax(s, **kw).float().cpu().numpy()
    out = out.float().cpu().numpy()
    if tdt == torch.float32:
        tol = 2.0 ** -21 * np.abs(plain).max(-1, keepdims=True)
    else:
        tol = _bf16_ulp(plain)
    assert (np.abs(out - plain) <= tol).all()
