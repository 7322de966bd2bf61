"""The fused scale + causal mask + softmax: the port's plain version against
the JAX reference and against the Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it) on the same numpy inputs, fp32 within
1e-6 (rows summing to 1 within 1e-5) and bf16 within 1 bf16 ulp of each
JAX output; ragged Sq, which the Pallas kernel rejects, against the JAX
reference; the wrapper's contract and CPU dispatch; the kernel's plan (a
pure function of the shapes) at ``chip_smoke.py``'s cases and at the
variants' boundaries; bf16 outputs held to a float64 softmax; and, on a
card only, the CUDA kernel against the plain version at every variant of
the plan."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.kernels.fused_softmax import kernel as jkernel
    from repro.kernels.fused_softmax import ops as jops
    from repro.kernels.fused_softmax import ref as jref
except ImportError:         # the card's machine: only the gpu tests run
    jnp = None
from repro_torch.kernels.fused_softmax import ops, ref

torch.set_num_threads(2)

ATOL = 1e-6
SCALE = 0.125
DTYPES = {"fp32": (torch.float32, jnp and jnp.float32),
          "bf16": (torch.bfloat16, jnp and jnp.bfloat16)}

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


def _chip_smoke_cases():
    """``chip_smoke.py``'s SOFTMAX_CASES (the module is imported from its
    path; importing it runs nothing)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SOFTMAX_CASES


# chip_smoke's cases by name: the plan each takes
CASE_PLANS = {
    "bert-large Phase 2, B4 x 16 heads": ops.SoftmaxPlan(False, 4, 16, 128),
    "bert-large Phase 1, B32 x 16 heads": ops.SoftmaxPlan(False, 4, 4, 128),
    "Phase 2 in bf16": ops.SoftmaxPlan(False, 8, 16, 128),
    "ragged Sq 1500, causal": ops.SoftmaxPlan(True, 4, 16, 96),
    "last chunk of a long prompt, q_offset 3840": ops.SoftmaxPlan(
        True, 8, 16, 256),
    "q_offset -1, row 0 fully masked": ops.SoftmaxPlan(False, 4, 4, 128),
    "Sk 12288, a 48 KB row": ops.SoftmaxPlan(True, 8, 16, 768),
    "Sk 32768, the kernel's largest": ops.SoftmaxPlan(True, 8, 32, 1024),
}


def test_softmax_plan_covers_every_chip_smoke_case():
    cases = _chip_smoke_cases()
    assert set(cases) == set(CASE_PLANS)
    for name, (n, sq, sk, dt, _, _) in cases.items():
        assert ops.softmax_plan(n * sq, sk, dt) == CASE_PLANS[name], name


@pytest.mark.parametrize("sk,dt,cta,vec,per", [
    (512, torch.float32, False, 4, 16), (513, torch.float32, True, 1, 16),
    (512, torch.bfloat16, False, 8, 16), (513, torch.bfloat16, True, 1, 16),
    (1024, torch.float32, True, 4, 16), (1025, torch.float32, True, 1, 16),
    (2048, torch.bfloat16, True, 8, 16), (2049, torch.bfloat16, True, 1, 16),
    (2044, torch.bfloat16, True, 4, 16), (128, torch.float32, False, 4, 4),
    (128, torch.bfloat16, False, 8, 8), (130, torch.bfloat16, False, 1, 8),
    (1, torch.float32, False, 1, 4), (32768, torch.float32, True, 4, 32),
    (16384, torch.bfloat16, True, 8, 16), (16385, torch.bfloat16, True, 1,
                                           32)])
def test_softmax_plan_variant_boundaries(sk, dt, cta, vec, per):
    """A warp a row while a lane holds at most 16 elements (Sk 512), a CTA
    above, 16 a thread to 16384 columns and 32 past them; the widest load
    that divides Sk; the row always fits the variant's registers, whole
    vectors, threads in whole warps (1024 fp32 and 2048 bf16 columns, which
    a warp's registers could hold, go to a CTA too)."""
    plan = ops.softmax_plan(4096, sk, dt)        # rows enough to fill the card
    assert (plan.cta, plan.vec, plan.per) == (cta, vec, per)
    assert sk % plan.vec == 0 and plan.per % plan.vec == 0
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    if plan.cta:
        assert plan.per in ops.CTA_PER
        assert plan.threads * plan.per >= sk
        assert (plan.threads - 32) * plan.per < sk     # the fewest warps
    else:
        assert plan.per in ops.WARP_PER and plan.threads == ops.WARP_THREADS
        assert 32 * plan.per >= sk
        assert all(32 * p < sk or p < plan.vec          # the fewest a lane
                   for p in ops.WARP_PER if p < plan.per)


@pytest.mark.parametrize("rows,sk", [
    (16, 32768), (1, 32768), (4, 12288), (66, 8192), (67, 8192), (1, 4096),
    (1, 4097), (33, 4097), (256, 12288)])
def test_softmax_plan_gives_long_rows_one_cta_however_few(rows, sk):
    """A long row is one CTA's however few the rows (a row over a cluster
    of CTAs saved some 3.7 us at [2, 8, 32768] on an H100, a workload no
    path has): the plan does not depend on the number of rows, and the
    CTA holds the row in the fewest whole warps."""
    plan = ops.softmax_plan(rows, sk, torch.bfloat16)
    assert plan == ops.softmax_plan(4096, sk, torch.bfloat16)
    assert plan.cta and plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.threads * plan.per >= sk > (plan.threads - 32) * plan.per


def test_softmax_plan_is_pure_and_cached():
    ops.softmax_plan.cache_clear()
    a = ops.softmax_plan(36000, 1500, torch.bfloat16)
    b = ops.softmax_plan(36000, 1500, torch.bfloat16)
    assert a is b and ops.softmax_plan.cache_info().hits == 1
    assert ops.softmax_plan(7, 1500, torch.bfloat16) == a
    with pytest.raises(ValueError):
        ops.softmax_plan(4, ops.MAX_SK + 1, torch.float32)
    with pytest.raises(TypeError):
        ops.softmax_plan(4, 128, torch.float16)


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


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dt,causal,off", [
    ((3, 17, 128), torch.float32, False, 0),       # warp, 16 B, 4 a lane
    ((2, 16, 512), torch.float32, True, 300),      # warp, 16 B, 16 a lane
    ((4, 9, 130), torch.bfloat16, True, 40),       # warp, one element
    ((2, 7, 96), torch.bfloat16, True, -3),        # warp, empty rows
    ((3, 40, 1024), torch.float32, True, 600),     # CTA, 16 B
    ((2, 16, 1022), torch.float32, False, 0),      # CTA, one element
    ((2, 16, 2048), torch.bfloat16, True, 2000),   # CTA, 16 B
    ((2, 33, 1500), torch.bfloat16, True, 0),      # CTA, 8 B
    ((2, 8, 2049), torch.bfloat16, False, 0),      # CTA, one element
    ((1, 4, 32768), torch.float32, True, 32760),   # CTA, 32 a thread, the
                                                   # kernel's largest
    ((200, 1, 20000), torch.float32, False, 0),    # CTA, 32 a thread
    ((1, 3, 4097), torch.bfloat16, True, 4090),    # CTA, one element a
                                                   # load, few long rows
    ((3, 5, 4096), torch.bfloat16, True, -2),      # CTA, every row empty
])
def test_kernel_matches_plain_at_every_plan_variant_on_card(shape, dt,
                                                            causal, off):
    """Each variant of ``softmax_plan`` against the plain version on the
    card (fp32 within 2^-21 of each row's largest output, bf16 within 1
    bf16 ulp), masked entries exactly 0, empty rows exactly 1 / Sk; and the
    same scores from a base one element off 16-byte alignment (loads of
    one element)."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card (sm_90a)")
    kw = dict(scale=SCALE, causal=causal, q_offset=off)
    base = torch.from_numpy(_scores(11, (int(np.prod(shape)) + 1,))).cuda()
    base = base.to(dt)
    for s in (base[:-1].view(shape), base[1:].view(shape)):
        n = ops.LAUNCHES["scale_mask_softmax"]
        out = ops.scale_mask_softmax(s, **kw)
        assert ops.LAUNCHES["scale_mask_softmax"] == n + 1
        plain = ref.scale_mask_softmax(s, **kw)
        o, p = out.float().cpu().numpy(), plain.float().cpu().numpy()
        if dt == torch.float32:
            tol = 2.0 ** -21 * np.abs(p).max(-1, keepdims=True)
        else:
            tol = _bf16_ulp(p)
        assert (np.abs(o - p) <= tol).all()
        if causal:
            sq, sk = shape[-2:]
            cols = np.arange(sk)[None, :]
            rows = np.arange(sq)[:, None] + off
            masked = (cols > rows) & (rows >= 0)
            empty = (rows < 0)[:, 0]
            assert (o[:, masked] == 0).all()
            assert (o[:, empty] == p[:, empty]).all()   # 1 / Sk, rounded
