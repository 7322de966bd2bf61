"""How the port's decode-shaped norm kernels split a row
(``fused_layernorm.ops.norm_plan``), and ragged row counts against the JAX
package.

- ``norm_plan`` for both kernels at every d_model and mamba inner width of
  the JAX package's registered configs, at 8, 64 and 300 rows: CTAs of
  whole warps, each thread a whole number of 16-byte vectors, covering the
  row exactly, clusters only where the rows' CTAs fit the card in one
  wave, the same from call to call; the plans the device times chose at
  the measured shapes; rows the register path cannot cover exactly (D not
  a multiple of 8, or past its widest plan) take the wide variant.
- A fault of the reference: the Pallas kernels assert whole 256-row tiles,
  and JAX's ops pass B * S rows through unpadded, so a 300-token mamba2
  prompt fails on a TPU. The port's plain versions take 300 rows and match
  JAX's references in fp32 as ``test_torch_fused_decode.py`` (the add +
  norm: 1e-6 absolute, x + y bitwise) and ``test_torch_ssm.py`` (the gated
  norm: 1e-5 relative and 1e-6 absolute) hold them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY
from repro.kernels.fused_layernorm import kernel as jln_kernel
from repro.kernels.fused_layernorm import ref as jln_ref
from repro.models import ssm as jssm
from repro_torch.kernels.fused_layernorm import ops as ln_ops
from repro_torch.kernels.fused_layernorm import ref as ln_ref

torch.set_num_threads(2)

WIDTHS = sorted({a.d_model for a in REGISTRY.values()}
                | {jssm.inner_dim(a) for a in REGISTRY.values()
                   if a.ssm is not None})


def test_registered_widths_reach_mistral_large_and_jamba():
    """The widths the plan must cover: d_model up to 12288 (mistral-large)
    and a mamba inner width up to 8192 (jamba)."""
    assert max(WIDTHS) == 12288
    assert 8192 in WIDTHS and 4096 in WIDTHS and 3072 in WIDTHS


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("rows", [8, 64, 300])
@pytest.mark.parametrize("d", WIDTHS)
def test_norm_plan_covers_every_registered_width_exactly(d, rows, gated):
    threads, vecs, ctas = ln_ops.norm_plan(rows, d, gated)
    assert vecs in ln_ops.NORM_VECTORS, "a registered width went wide"
    assert threads % 32 == 0 and 32 <= threads <= ln_ops.NORM_MAX_THREADS
    assert ctas in ln_ops.NORM_CTAS
    assert ctas == 1 or rows * ctas <= ln_ops.NORM_SMS
    assert threads * vecs * ctas * 8 == d
    assert ln_ops.norm_plan(rows, d, gated) == (threads, vecs, ctas)
    assert ln_ops.norm_plan.__wrapped__(rows, d, gated) == (threads, vecs,
                                                            ctas)


@pytest.mark.parametrize("rows,d,gated,plan", [
    (8, 3072, False, (192, 2, 1)), (64, 3072, False, (192, 2, 1)),
    (300, 3072, False, (192, 2, 1)), (8, 12288, False, (192, 2, 4)),
    (300, 12288, False, (384, 4, 1)), (8, 4096, True, (64, 1, 8)),
    (64, 4096, True, (512, 1, 1)), (300, 4096, True, (512, 1, 1)),
    (8, 8192, True, (128, 1, 8)), (1, 4096, True, (64, 1, 8))])
def test_norm_plan_at_the_measured_shapes(rows, d, gated, plan):
    """The plans the device times chose (norm_ablations.py): the add +
    norm on one CTA of at most 256 threads where 2 vectors a thread allow
    it, a cluster for mistral-large's 12288 at 8 rows; the gated norm one
    vector a thread over 8 CTAs a row at decode shapes, one CTA from 64
    rows."""
    assert ln_ops.norm_plan(rows, d, gated) == plan


@pytest.mark.parametrize("d", [3070, 3071, 4100, 8000, 40000,
                               ln_ops._RESNORM_MAX_D])
def test_norm_plan_sends_other_rows_to_the_wide_variant(d):
    """D not a multiple of 8 (decode_residual_norm takes any D), a vector
    count no CTAs of whole warps divide, and rows past the register path."""
    for rows in (1, 8, 300):
        for gated in (False, True):
            assert ln_ops.norm_plan(rows, d, gated) == ln_ops.NORM_WIDE
    assert ln_ops.NORM_WIDE[1] == 0


def test_norm_plan_widest_register_row():
    """On one CTA the register path ends at 512 threads of 4 vectors (16384
    values): at 300 rows, where no cluster fits the card, the next width
    goes wide; at 8 rows a cluster of 8 CTAs takes it."""
    assert ln_ops.norm_plan(300, 16384) == (512, 4, 1)
    assert ln_ops.norm_plan(300, 16384 + 4096) == ln_ops.NORM_WIDE
    assert ln_ops.norm_plan(8, 16384 + 4096) == (160, 2, 8)


def test_norm_plan_reads_no_tensor():
    """Plain integers in, plain integers out: nothing to read from a card."""
    ln_ops.norm_plan.cache_clear()
    plan = ln_ops.norm_plan(8, 3072)
    assert all(type(v) is int for v in plan)
    assert plan == ln_ops.norm_plan(8, 3072)
    assert ln_ops.norm_plan.cache_info().hits >= 1


# --------------------------------------------- ragged rows, the reference ----

def _norm_inputs(rows, d, seed):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(rows, d)).astype(np.float32)
    x = (2 * rng.normal(size=(rows, d))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (d,)).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, (d,)).astype(np.float32)
    return y, x, scale, bias


@pytest.mark.parametrize("fn", ["decode_residual_norm", "gated_rmsnorm"])
def test_jax_norm_kernels_assert_on_300_rows(fn):
    """A fault of the reference: ``decode_residual_norm`` and
    ``gated_rmsnorm`` assert ``r % min(256, r) == 0``
    (``repro/kernels/fused_layernorm/kernel.py:92`` and ``:132``), and
    JAX's ops pass B * S rows through unpadded, so on a TPU a 300-token
    prompt through a mamba2 layer (or 300 decode rows through the fused
    add + norm) fails there. The port takes any row count
    (``test_plain_norms_take_300_rows_and_match_jax``)."""
    y, x, scale, _ = (jnp.asarray(a) for a in _norm_inputs(300, 64, 4))
    with pytest.raises(AssertionError, match="300, 256"):
        getattr(jln_kernel, fn)(y, x, scale, interpret=True)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "gated"])
def test_plain_norms_take_300_rows_and_match_jax(kind):
    y, x, scale, bias = _norm_inputs(300, 128, 5)
    t = [torch.from_numpy(a.copy()) for a in (y, x, scale, bias)]
    j = [jnp.asarray(a) for a in (y, x, scale, bias)]
    if kind == "gated":
        got = ln_ref.gated_rmsnorm(t[0], t[1], t[2])
        want = jln_ref.gated_rmsnorm(j[0], j[1], j[2])
        n = ln_ops.LAUNCHES["gated_rmsnorm"]
        assert torch.equal(ln_ops.gated_rmsnorm(t[0], t[1], t[2]), got)
        assert ln_ops.LAUNCHES["gated_rmsnorm"] == n
    else:
        b, jb = (None, None) if kind == "rmsnorm" else (t[3], j[3])
        got, x2 = ln_ref.decode_residual_norm(t[0], t[1], t[2], b, kind=kind)
        want, jx2 = jln_ref.decode_residual_norm(j[0], j[1], j[2], jb,
                                                 kind=kind)
        np.testing.assert_array_equal(x2.numpy(), np.asarray(jx2))
        n = ln_ops.LAUNCHES["decode_residual_norm"]
        for a, w in zip(ln_ops.decode_residual_norm(t[0], t[1], t[2], b,
                                                    kind=kind), (got, x2)):
            assert torch.equal(a, w)
        assert ln_ops.LAUNCHES["decode_residual_norm"] == n
    assert got.shape == (300, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5 if kind == "gated" else 0,
                               atol=1e-6)


def test_jax_norm_kernels_take_256_rows():
    """The same kernels take a whole 256-row tile: the assert, not the
    arithmetic, is what 300 rows trip."""
    y, x, scale, _ = (jnp.asarray(a) for a in _norm_inputs(256, 64, 6))
    h, x2 = jax.jit(lambda *a: jln_kernel.decode_residual_norm(
        *a, interpret=True))(y, x, scale)
    want_h, want_x2 = jln_ref.decode_residual_norm(y, x, scale)
    np.testing.assert_array_equal(np.asarray(x2), np.asarray(want_x2))
    np.testing.assert_allclose(np.asarray(h), np.asarray(want_h), rtol=0,
                               atol=1e-6)


# ------------------------------------------------ the launch arguments ----

class _Recorder:
    """Stands in for a bound C entry point: records its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture()
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(ln_ops._build, "bind", lambda *a: rec)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    return rec


def test_launch_resnorm_passes_the_plan_and_goes_wide_when_misaligned(
        recorder):
    """The C entry point's arguments in order (pointers, rows, D, kind, the
    plan, eps, stream); a base that is not 16-byte aligned takes the wide
    variant, whose loads are scalar."""
    buf = torch.zeros(4 * 3072 + 8, dtype=torch.bfloat16)
    y = buf[:4 * 3072].view(4, 3072)
    x, h, xo = (torch.zeros(4, 3072, dtype=torch.bfloat16) for _ in range(3))
    scale = torch.ones(3072, dtype=torch.bfloat16)
    plan = ln_ops.norm_plan(4, 3072)
    ln_ops._launch_resnorm(y, x, scale, None, h, xo, "layernorm", 1e-5, plan)
    args = recorder.calls[-1]
    assert args[3] is None
    assert args[6:] == (4, 3072, 1, *plan, 1e-5, 7)
    shifted = buf[1:1 + 4 * 3072].view(4, 3072)      # 2 bytes off
    ln_ops._launch_resnorm(shifted, x, scale, None, h, xo, "rmsnorm", 1e-5,
                           plan)
    assert recorder.calls[-1][6:] == (4, 3072, 0, *ln_ops.NORM_WIDE, 1e-5, 7)


def test_launch_gated_passes_row_strides_and_the_plan(recorder):
    proj = torch.zeros(8, 8512, dtype=torch.bfloat16)
    y = torch.zeros(8, 4096, dtype=torch.bfloat16)
    out = torch.empty_like(y)
    scale = torch.ones(4096, dtype=torch.bfloat16)
    plan = ln_ops.norm_plan(8, 4096, True)
    ln_ops._launch_gated(y, proj[:, :4096], scale, out, 1e-5, plan)
    assert recorder.calls[-1][4:] == (8, 4096, 4096, 8512, *plan, 1e-5, 7)
