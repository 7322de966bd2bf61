"""The training path's kernels in the port against the JAX package: the
fused residual add + norm, the fused bias + GeLU and the two LAMB stages.

Each plain version is held against the JAX reference and, where the
shapes allow, the Pallas kernel in interpret mode, on the same numpy
inputs (float32 unless a test says otherwise):

- ``fused_residual_layernorm`` and ``bias_gelu``: outputs within 1e-5
  absolute in fp32; gradients of ``PlainBackward`` (the card's backward)
  against ``jax.grad`` of the reference within 1e-5 absolute / 1e-4
  relative. In bf16 the norm is within 1 bf16 ulp of max(|output|,
  |output before the bias|) of JAX's: the two differ only in the order of
  the fp32 statistics, and cancellation against the bias can lift that
  fp32 difference above an ulp of a small output.
- ``bias_gelu`` in bf16: JAX's reference applies GeLU in bf16 arithmetic
  (XLA rounds each operation on the CPU), so it is not a bf16 yardstick;
  the port's plain version (one rounding of an fp32 evaluation) is held
  within 1 bf16 ulp + |h| * 2^-22 of a float64 evaluation of the same bf16
  sum h, and its fp32 evaluation against the Pallas kernel (fp32 math) by
  the same bound. The |h| * 2^-22 term is the fp32 formula's own error in
  its cancelling tail (h < -4, where 1 + tanh(.) nearly vanishes).
- LAMB: a one-row leaf against the Pallas stage 1 + 2 (interpret), where
  its per-row trust ratio is the per-leaf one, ragged lengths included;
  2-D leaves against ``ref.lamb_stage12`` reducing over all axes (the
  reference's per-layer ratio); w, m, v within 1e-6 absolute.
- On a card only (``gpu`` marker): each CUDA kernel against its plain
  version, with the tolerances ``chip_smoke.py`` states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bias_gelu import kernel as jbg_kernel
from repro.kernels.bias_gelu import ref as jbg_ref
from repro.kernels.fused_lamb import ops as jlamb_ops
from repro.kernels.fused_lamb import ref as jlamb_ref
from repro.kernels.fused_layernorm import kernel as jln_kernel
from repro.kernels.fused_layernorm import ref as jln_ref
from repro_torch.kernels._grad import PlainBackward
from repro_torch.kernels.bias_gelu import ops as bg_ops
from repro_torch.kernels.bias_gelu import ref as bg_ref
from repro_torch.kernels.fused_lamb import ops as lamb_ops
from repro_torch.kernels.fused_lamb import ref as lamb_ref
from repro_torch.kernels.fused_layernorm import ops as ln_ops
from repro_torch.kernels.fused_layernorm import ref as ln_ref

torch.set_num_threads(2)

LAMB_KW = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01, lr=3e-4)


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(a.astype(np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round to bf16 and back, so both frameworks get the same values."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _t(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _norm_inputs(shape, seed, bias: bool):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    r = rng.normal(size=shape).astype(np.float32)
    s = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    b = (0.1 * rng.normal(size=d)).astype(np.float32) if bias else None
    return x, r, s, b


# -------------------------------------------------- fused_residual_layernorm --

@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("shape", [(256, 128), (2, 32, 384)])
def test_residual_layernorm_plain_matches_jax_fp32(shape, rms):
    x, r, s, b = _norm_inputs(shape, 1, not rms)
    want = np.asarray(jln_ref.fused_residual_layernorm(
        x, r, s, b, rms=rms))
    got = ln_ref.fused_residual_layernorm(
        _t(x), _t(r), _t(s), None if b is None else _t(b), rms=rms)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    x2, r2 = x.reshape(-1, shape[-1]), r.reshape(-1, shape[-1])
    pallas = np.asarray(jln_kernel.fused_residual_layernorm(
        x2, r2, s, b, rms=rms, interpret=True)).reshape(shape)
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-5, rtol=0)


@pytest.mark.parametrize("rms", [False, True])
def test_residual_layernorm_plain_matches_jax_bf16(rms):
    x, r, s, b = (None if a is None else _bf16(a)
                  for a in _norm_inputs((256, 384), 2, not rms))
    jb = None if b is None else jnp.asarray(b, jnp.bfloat16)
    args = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(r, jnp.bfloat16),
            jnp.asarray(s, jnp.bfloat16))
    want = np.asarray(jln_ref.fused_residual_layernorm(
        *args, jb, rms=rms).astype(jnp.float32))
    pre = np.asarray(jln_ref.fused_residual_layernorm(
        *args, None, rms=rms).astype(jnp.float32))
    pallas = np.asarray(jln_kernel.fused_residual_layernorm(
        *args, jb, rms=rms, interpret=True).astype(jnp.float32))
    got = ln_ref.fused_residual_layernorm(
        _t(x, torch.bfloat16), _t(r, torch.bfloat16),
        _t(s, torch.bfloat16), None if b is None else _t(b, torch.bfloat16),
        rms=rms).float().numpy()
    tol = _bf16_ulp(np.maximum(np.abs(want), np.abs(pre)))
    assert (np.abs(got - want) <= tol).all()
    assert (np.abs(got - pallas) <= tol).all()


@pytest.mark.parametrize("rms", [False, True])
def test_residual_layernorm_gradient_matches_jax(rms):
    """``PlainBackward`` (the wrapper's backward on the card) against
    ``jax.grad`` of the reference, for x, residual, scale and bias."""
    x, r, s, b = _norm_inputs((4, 8, 128), 3, not rms)
    ct = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jln_ref.fused_residual_layernorm(*a, rms=rms) * ct)
    argnums = (0, 1, 2) if rms else (0, 1, 2, 3)
    want = jax.grad(jloss, argnums=argnums)(x, r, s, b)
    ts = [None if a is None else _t(a).requires_grad_(True)
          for a in (x, r, s, b)]
    plain = (lambda *a: ln_ref.fused_residual_layernorm(*a, rms=rms))
    y = PlainBackward.apply(plain, plain, *ts)
    (y * _t(ct)).sum().backward()
    for w, t in zip(want, ts):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-4)
    if rms:
        assert ts[3] is None


# ---------------------------------------------------------------- bias_gelu --

@pytest.mark.parametrize("with_bias", [True, False])
def test_bias_gelu_plain_matches_jax_fp32(with_bias):
    rng = np.random.default_rng(5)
    x = (2 * rng.normal(size=(256, 512))).astype(np.float32)
    b = (0.5 * rng.normal(size=512)).astype(np.float32) if with_bias \
        else None
    got = bg_ref.bias_gelu(_t(x), None if b is None else _t(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jbg_ref.bias_gelu(x, b)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(jbg_kernel.bias_gelu(x, b, interpret=True)),
        atol=1e-6, rtol=0)


def test_bias_gelu_plain_bf16_within_an_ulp():
    rng = np.random.default_rng(6)
    x = _bf16((2 * rng.normal(size=(256, 512))).astype(np.float32))
    b = _bf16((0.5 * rng.normal(size=512)).astype(np.float32))
    got = bg_ref.bias_gelu(_t(x, torch.bfloat16),
                           _t(b, torch.bfloat16)).float().numpy()
    h = _bf16(x + b)                      # the plain version's bf16 sum
    exact = torch.nn.functional.gelu(torch.from_numpy(h.copy()).double(),
                                     approximate="tanh").numpy()
    tol = _bf16_ulp(exact) + np.abs(h) * 2.0 ** -22
    assert (np.abs(got - exact) <= tol).all()
    # the kernel's arithmetic (fp32 sum, fp32 GeLU, one rounding) against
    # the Pallas kernel's, which is the same
    f32 = _bf16(bg_ref.bias_gelu(_t(x), _t(b)).numpy())
    pallas = np.asarray(jbg_kernel.bias_gelu(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
        interpret=True).astype(jnp.float32))
    assert (np.abs(f32 - pallas) <= _bf16_ulp(pallas)
            + np.abs(x + b) * 2.0 ** -22).all()


def test_bias_gelu_gradient_matches_jax():
    rng = np.random.default_rng(7)
    x = (2 * rng.normal(size=(3, 16, 256))).astype(np.float32)
    b = (0.5 * rng.normal(size=256)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    want = jax.grad(lambda x, b: jnp.sum(jbg_ref.bias_gelu(x, b) * ct),
                    argnums=(0, 1))(x, b)
    tx, tb = _t(x).requires_grad_(True), _t(b).requires_grad_(True)
    y = PlainBackward.apply(bg_ref.bias_gelu, bg_ref.bias_gelu, tx, tb)
    (y * _t(ct)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want[1]),
                               atol=1e-5, rtol=1e-4)


def test_plain_backward_skips_inputs_without_grad():
    rng = np.random.default_rng(8)
    x = _t(rng.normal(size=(4, 64))).requires_grad_(True)
    b = _t(rng.normal(size=64))
    y = PlainBackward.apply(bg_ref.bias_gelu, bg_ref.bias_gelu, x, b)
    y.sum().backward()
    assert x.grad is not None and b.grad is None
    z = PlainBackward.apply(bg_ref.bias_gelu, bg_ref.bias_gelu, x, None)
    (gx,) = torch.autograd.grad(z.sum(), [x])
    np.testing.assert_allclose(gx.numpy(), jax.grad(
        lambda a: jnp.sum(jbg_ref.bias_gelu(a)))(x.detach().numpy()),
        atol=1e-6)


# --------------------------------------------------------------------- LAMB --

def _lamb_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    m = (0.1 * rng.normal(size=shape)).astype(np.float32)
    v = (0.01 * np.abs(rng.normal(size=shape))).astype(np.float32)
    return w, g, m, v


def _port_update(w, g, m, v, ginv, c1, c2):
    tw, tm, tv = _t(w), _t(m), _t(v)
    r = lamb_ops.lamb_update_(tw, _t(g), tm, tv,
                              torch.tensor([ginv, c1, c2]), **LAMB_KW)
    return tw.numpy(), tm.numpy(), tv.numpy(), r


@pytest.mark.parametrize("f", [2048, 4099, 300])
def test_lamb_one_row_matches_pallas(f):
    """On a [1, F] leaf the Pallas path's per-row trust ratio is the
    per-leaf one, so the two must agree; F = 4099 and 300 are ragged
    (the Pallas wrapper pads to its 2048 tile, the port masks)."""
    w, g, m, v = _lamb_inputs((1, f), f)
    sc = dict(ginv=0.3, c1=1.5, c2=1.2)
    want = jlamb_ops.lamb_stage12(w, g, m, v, interpret=True, **sc,
                                  **LAMB_KW)
    got = _port_update(w, g, m, v, *sc.values())
    for a, b in zip(got[:3], want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(3, 256), (64, 96), (1024,)])
def test_lamb_leaf_matches_reference_per_layer(shape):
    w, g, m, v = _lamb_inputs(shape, sum(shape))
    sc = dict(ginv=0.05, c1=10.0, c2=1000.0)
    want = jlamb_ref.lamb_stage12(w, g, m, v, red_axes=tuple(
        range(len(shape))), **sc, **LAMB_KW)
    got = _port_update(w, g, m, v, *sc.values())
    for a, b in zip(got[:3], want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)
    m1, v1, u = jlamb_ref.lamb_stage1(w, g, m, v, beta1=0.9, beta2=0.999,
                                      eps=1e-6, weight_decay=0.01, **sc)
    r = np.sqrt(np.sum(np.square(w))) / np.sqrt(np.sum(np.square(u)))
    np.testing.assert_allclose(got[3].numpy(), [r], rtol=1e-5)


def test_jax_pallas_lamb_reduces_per_row_where_the_port_reduces_per_layer():
    """The fault of the reference recorded in ROADMAP queue 3: on a stacked
    [L, D, F] leaf JAX's Pallas path (``fused_lamb/ops.py``) takes one
    trust ratio per last-axis row, where Fig. 3 and ``optim/lamb.py`` take
    one per layer. The Pallas result equals the per-row reference; the
    port's per-leaf update equals the per-layer one (each port leaf is
    one layer); the two differ by 1-10% of the update step."""
    w, g, m, v = _lamb_inputs((2, 4, 2048), 10)
    sc = dict(ginv=0.3, c1=1.5, c2=1.2)
    pallas = jlamb_ops.lamb_stage12(w, g, m, v, interpret=True,
                                    red_axes=(1, 2), **sc, **LAMB_KW)
    per_row = jlamb_ref.lamb_stage12(w, g, m, v, red_axes=(-1,), **sc,
                                     **LAMB_KW)
    per_layer = jlamb_ref.lamb_stage12(w, g, m, v, red_axes=(1, 2), **sc,
                                       **LAMB_KW)
    np.testing.assert_allclose(np.asarray(pallas[0]), per_row[0],
                               atol=1e-6)
    for layer in range(2):
        got = _port_update(w[layer], g[layer], m[layer], v[layer],
                           *sc.values())
        np.testing.assert_allclose(got[0], np.asarray(per_layer[0][layer]),
                                   atol=1e-6)
    step = np.abs(np.asarray(per_layer[0]) - w).max()
    fault = np.abs(np.asarray(pallas[0]) - np.asarray(per_layer[0])).max()
    assert 0.01 * step < fault < 0.1 * step


def test_lamb_trust_ratio_is_one_for_zero_weights():
    """A zero-initialized bias has ||w|| = 0: r = 1, as the reference."""
    _, g, m, v = _lamb_inputs((512,), 9)
    w = np.zeros(512, np.float32)
    got = _port_update(w, g, m, v, 0.5, 1.0, 1.0)
    want = jlamb_ref.lamb_stage12(w, g, m, v, ginv=0.5, c1=1.0, c2=1.0,
                                  red_axes=(0,), **LAMB_KW)
    assert got[3].item() == 1.0
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-7)


def test_cpu_wrappers_count_no_launch():
    before = (dict(ln_ops.LAUNCHES), dict(bg_ops.LAUNCHES),
              dict(lamb_ops.LAUNCHES))
    x = torch.randn(4, 256)
    ln_ops.fused_residual_layernorm(x, x, torch.ones(256), torch.zeros(256))
    bg_ops.bias_gelu(x, torch.zeros(256))
    w, m, v = torch.randn(256), torch.zeros(256), torch.zeros(256)
    lamb_ops.lamb_update_(w, torch.randn(256), m, v,
                          torch.tensor([1.0, 10.0, 1000.0]), **LAMB_KW)
    assert (dict(ln_ops.LAUNCHES), dict(bg_ops.LAUNCHES),
            dict(lamb_ops.LAUNCHES)) == before


def test_lamb_grid_is_capped():
    assert lamb_ops.grid_blocks(1) == 1
    assert lamb_ops.grid_blocks(4 * 256 + 1) == 2
    assert lamb_ops.grid_blocks(30592 * 1024) == 4 * 132


# ------------------------------------------------------------- on a card ----

def _card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card (sm_90a)")


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1024, 4096])
def test_residual_layernorm_kernel_matches_plain_on_card(rows):
    _card()
    g = torch.Generator(device="cuda").manual_seed(rows)
    d = 1024
    x, r = (torch.randn((rows, d), generator=g, device="cuda").bfloat16()
            for _ in range(2))
    s = (1 + 0.1 * torch.randn((d,), generator=g, device="cuda")).bfloat16()
    b = (0.1 * torch.randn((d,), generator=g, device="cuda")).bfloat16()
    n = ln_ops.LAUNCHES["fused_residual_layernorm"]
    y = ln_ops.fused_residual_layernorm(x, r, s, b)
    assert ln_ops.LAUNCHES["fused_residual_layernorm"] == n + 1
    p = ln_ref.fused_residual_layernorm(x, r, s, b).float().cpu().numpy()
    pre = ln_ref.fused_residual_layernorm(x, r, s).float().cpu().numpy()
    tol = _bf16_ulp(np.maximum(np.abs(p), np.abs(pre)))
    assert (np.abs(y.float().cpu().numpy() - p) <= tol).all()


@pytest.mark.gpu
def test_bias_gelu_kernel_matches_plain_on_card():
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (2 * torch.randn((1024, 4096), generator=g, device="cuda")).bfloat16()
    b = (0.5 * torch.randn((4096,), generator=g, device="cuda")).bfloat16()
    n = bg_ops.LAUNCHES["bias_gelu"]
    y = bg_ops.bias_gelu(x, b).float().cpu().numpy()
    assert bg_ops.LAUNCHES["bias_gelu"] == n + 1
    p = bg_ref.bias_gelu(x.float(), b.float()).bfloat16().float().cpu().numpy()
    h = (x.float() + b.float()).cpu().numpy()
    assert (np.abs(y - p) <= _bf16_ulp(p) + np.abs(h) * 2.0 ** -22).all()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1024, 3072), (4099,)])
def test_lamb_kernels_match_plain_on_card(shape):
    _card()
    g = torch.Generator(device="cuda").manual_seed(1)
    w = 0.05 * torch.randn(shape, generator=g, device="cuda")
    gr = (1e-3 * torch.randn(shape, generator=g, device="cuda")).bfloat16()
    m = 1e-4 * torch.randn(shape, generator=g, device="cuda")
    v = 1e-7 * torch.rand(shape, generator=g, device="cuda")
    sc = torch.tensor([0.7, 1.5, 1.2], device="cuda")
    pw, pm, pv, pr = lamb_ref.lamb_stage12(w, gr, m, v, ginv=sc[0],
                                           c1=sc[1], c2=sc[2], **LAMB_KW)
    n = lamb_ops.LAUNCHES["lamb_stage1"]
    r = lamb_ops.lamb_update_(w, gr, m, v, sc, **LAMB_KW)
    assert lamb_ops.LAUNCHES["lamb_stage1"] == n + 1
    assert torch.equal(m, pm) and torch.equal(v, pv)
    assert abs(r.item() / pr.item() - 1) <= 1e-5
    assert (w - pw).abs().max().item() <= 4 * 2.0 ** -24 * pw.abs().max()
