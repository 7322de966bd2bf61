"""The port's mamba2 mixer (``repro_torch.models.ssm``) and its gated
RMSNorm kernel's plain version against the JAX package, on the same numpy
inputs (made from a seed) and the same weights (JAX's ``init_mamba``).

fp32 throughout unless a test says otherwise; the stated tolerance is 1e-5
relative and 1e-6 absolute. The serving layers are checked on the whole
state pool after the call: the padded final chunk, the ``start == 0`` reset
of a dirty slot and the untouched rows of other slots, and an inactive
decode slot whose row must not change at all. The CUDA kernel itself is
held against the plain version on a card only (``gpu`` marker).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.fused_layernorm import kernel as jln_kernel
from repro.kernels.fused_layernorm import ref as jln_ref
from repro.models import ssm as jssm
from repro_torch.configs import smoke_config
from repro_torch.kernels.fused_layernorm import ops as ln_ops
from repro_torch.kernels.fused_layernorm import ref as ln_ref
from repro_torch.models import layers as t_layers
from repro_torch.models import ssm as tssm

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


@pytest.fixture(scope="module")
def arch_pair():
    """(JAX arch, port arch, JAX mixer params, port mixer params): the
    mamba2 smoke config in fp32, weights from JAX's ``init_mamba``."""
    j = dataclasses.replace(jax_smoke_config("mamba2-1.3b"), dtype="float32",
                            param_dtype="float32")
    t = dataclasses.replace(smoke_config("mamba2-1.3b"), dtype="float32")
    jp = jssm.init_mamba(jax.random.key(3), j, jnp.float32)
    # a non-trivial gate scale and skip, so both are exercised
    rng = np.random.default_rng(9)
    jp = dict(jp, norm_scale=jnp.asarray(
        rng.uniform(0.5, 1.5, jp["norm_scale"].shape).astype(np.float32)),
        D=jnp.asarray(rng.uniform(0.5, 1.5, jp["D"].shape).astype(
            np.float32)))
    tp = {k: _t(v) for k, v in jp.items()}
    return j, t, jp, tp


def test_smoke_config_matches_jax_for_mamba2_and_keeps_dense():
    j, t = jax_smoke_config("mamba2-1.3b"), smoke_config("mamba2-1.3b")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "pos_emb", "tie_embeddings", "family"):
        assert getattr(t, f) == getattr(j, f), f
    assert dataclasses.asdict(t.ssm) == dataclasses.asdict(j.ssm)
    assert (t.num_heads, t.d_ff, t.ssm.state_dim, t.ssm.chunk) == (0, 0, 16,
                                                                    16)
    d = smoke_config("llama3.2-3b")
    assert (d.num_heads, d.num_kv_heads, d.d_ff, d.ssm) == (4, 2, 256, None)
    assert tssm.conv_channels(t) == jssm.conv_channels(j)
    assert tssm.num_ssm_heads(t) == jssm.num_ssm_heads(j)


def test_softplus_matches_jax_including_large_inputs():
    x = np.linspace(-40, 40, 801).astype(np.float32)
    _close(t_layers.softplus(_t(x)), jax.nn.softplus(jnp.asarray(x)))


def test_init_mamba_leaf_names_and_shapes_match_jax(arch_pair):
    j, t, jp, _ = arch_pair
    tp = tssm.init_mamba(torch.Generator().manual_seed(0), t, "cpu",
                         torch.float32)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
    a = -torch.exp(tp["A_log"])
    assert bool(((a <= -1.0) & (a >= -16.0)).all())
    dt = t_layers.softplus(tp["dt_bias"])
    assert bool(((dt > 0.9e-3) & (dt < 1.1e-1)).all())


def _ssd_inputs(seed, bsz=2, seq=32, h=4, p=8, g=2, n=6):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(bsz, seq, h, p)).astype(np.float32),
        dt=rng.uniform(0.01, 0.5, (bsz, seq, h)).astype(np.float32),
        a=-rng.uniform(0.5, 4.0, (h,)).astype(np.float32),
        b=rng.normal(size=(bsz, seq, g, n)).astype(np.float32),
        c=rng.normal(size=(bsz, seq, g, n)).astype(np.float32),
        s0=rng.normal(size=(bsz, h, n, p)).astype(np.float32))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked_matches_jax(with_state, chunk):
    i = _ssd_inputs(1)
    s0 = i["s0"] if with_state else None
    names = "x dt a b c".split()
    jy, jf = jssm.ssd_chunked(*(jnp.asarray(i[k]) for k in names), chunk,
                              None if s0 is None else jnp.asarray(s0))
    ty, tf_ = tssm.ssd_chunked(*(_t(i[k]) for k in names), chunk,
                               None if s0 is None else _t(s0))
    _close(ty, jy)
    _close(tf_, jf)


def test_ssd_decode_step_matches_jax_and_continues_the_scan():
    i = _ssd_inputs(2, seq=1)
    args = [i["s0"], i["x"][:, 0], i["dt"][:, 0], i["a"], i["b"][:, 0],
            i["c"][:, 0]]
    jy, js = jssm.ssd_decode_step(*(jnp.asarray(a) for a in args))
    ty, ts = tssm.ssd_decode_step(*(_t(a) for a in args))
    _close(ty, jy)
    _close(ts, js)
    # one decode step from the scan's final state equals one more scan step
    i = _ssd_inputs(4, seq=9)
    y9, _ = tssm.ssd_chunked(*(_t(i[k]) for k in "x dt a b c".split()), 9)
    _, s8 = tssm.ssd_chunked(_t(i["x"][:, :8]), _t(i["dt"][:, :8]),
                             _t(i["a"]), _t(i["b"][:, :8]),
                             _t(i["c"][:, :8]), 8)
    y, _ = tssm.ssd_decode_step(s8, _t(i["x"][:, 8]), _t(i["dt"][:, 8]),
                                _t(i["a"]), _t(i["b"][:, 8]),
                                _t(i["c"][:, 8]))
    _close(y, y9[:, 8].numpy())


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 11, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    _close(tssm._causal_conv(_t(x), _t(w)),
           jssm._causal_conv(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("seq", [32, 12])
def test_apply_mamba_matches_jax(arch_pair, seq):
    j, t, jp, tp = arch_pair
    u = np.random.default_rng(seq).normal(size=(2, seq, t.d_model)).astype(
        np.float32)
    # atol 1e-5: out_proj sums 256 products of O(1) terms in another order
    # than XLA, so an output near 0 can differ by a few ulps of the terms
    _close(tssm.apply_mamba(t, tp, _t(u)),
           jssm.apply_mamba(j, jp, jnp.asarray(u)), atol=1e-5)


def _pools(rng, t, num_slots):
    """A dirty per-slot pool: every row holds random state."""
    c = tssm.init_mamba_cache(t, num_slots, torch.float32, "cpu")
    return {k: rng.normal(size=tuple(v.shape)).astype(np.float32)
            for k, v in c.items()}


@pytest.mark.parametrize("start,total", [(0, 16), (0, 11), (16, 29),
                                         (16, 32)])
def test_paged_prefill_mamba_layer_matches_jax(arch_pair, start, total):
    """A 16-row chunk at ``start`` of a ``total``-token prompt in slot 2 of
    a dirty 4-slot pool: ``start == 0`` must ignore the slot's old rows,
    a padded final chunk (11, 29) must leave the state after the last
    valid token, and the other slots' rows must not change."""
    j, t, jp, tp = arch_pair
    rng = np.random.default_rng(start + total)
    pools = _pools(rng, t, 4)
    x = rng.normal(size=(1, 16, t.d_model)).astype(np.float32)
    jy, jc = jssm.paged_prefill_mamba_layer(
        j, jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in pools.items()},
        jnp.int32(2), jnp.int32(start), jnp.int32(total))
    tc = {k: _t(v) for k, v in pools.items()}
    ty = tssm.paged_prefill_mamba_layer(t, tp, _t(x), tc, 2, start, total)
    valid = total - start
    _close(ty[:, :valid], np.asarray(jy)[:, :valid])
    for k in pools:
        _close(tc[k][2], np.asarray(jc[k])[2])
        for s in (0, 1, 3):
            np.testing.assert_array_equal(tc[k][s].numpy(), pools[k][s])


def test_padded_chunk_state_equals_unpadded(arch_pair):
    """dt = 0 on padding: the 16-row chunk of an 11-token prompt leaves the
    same state and conv tail as an 11-row chunk of it."""
    _, t, _, tp = arch_pair
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 16, t.d_model)).astype(np.float32))
    a = tssm.init_mamba_cache(t, 1, torch.float32, "cpu")
    b = tssm.init_mamba_cache(t, 1, torch.float32, "cpu")
    tssm.paged_prefill_mamba_layer(t, tp, x, a, 0, 0, 11)
    old = t.ssm
    t11 = dataclasses.replace(t, ssm=dataclasses.replace(old, chunk=11))
    tssm.paged_prefill_mamba_layer(t11, tp, x[:, :11], b, 0, 0, 11)
    _close(a["state"], b["state"].numpy())
    _close(a["conv"], b["conv"].numpy())


def test_paged_decode_mamba_layer_matches_jax_and_keeps_inactive_rows(
        arch_pair):
    j, t, jp, tp = arch_pair
    rng = np.random.default_rng(17)
    pools = _pools(rng, t, 4)
    x = rng.normal(size=(4, 1, t.d_model)).astype(np.float32)
    active = np.array([True, False, True, True])
    jy, jc = jssm.paged_decode_mamba_layer(
        j, jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in pools.items()},
        jnp.asarray(active))
    tc = {k: _t(v) for k, v in pools.items()}
    ty = tssm.paged_decode_mamba_layer(t, tp, _t(x), tc,
                                       torch.from_numpy(active))
    _close(ty[active], np.asarray(jy)[active])
    for k in pools:
        _close(tc[k][active], np.asarray(jc[k])[active])
        np.testing.assert_array_equal(tc[k][1].numpy(), pools[k][1])


def test_decode_after_prefill_continues_the_full_sequence(arch_pair):
    """Chunked prefill (two chunks, the second padded) and then decode
    steps give the outputs of ``apply_mamba`` on the whole sequence."""
    _, t, _, tp = arch_pair
    n_pre, n_dec = 27, 3
    u = torch.from_numpy(np.random.default_rng(23).normal(
        size=(1, n_pre + n_dec, t.d_model)).astype(np.float32))
    t_full = dataclasses.replace(t, ssm=dataclasses.replace(
        t.ssm, chunk=n_pre + n_dec))
    want = tssm.apply_mamba(t_full, tp, u)
    cache = tssm.init_mamba_cache(t, 2, torch.float32, "cpu")
    outs = []
    for start in (0, 16):
        x = torch.zeros((1, 16, t.d_model))
        end = min(start + 16, n_pre)
        x[:, :end - start] = u[:, start:end]
        outs.append(tssm.paged_prefill_mamba_layer(t, tp, x, cache, 1, start,
                                                   n_pre)[:, :end - start])
    for i in range(n_pre, n_pre + n_dec):
        x = torch.zeros((2, 1, t.d_model))
        x[1] = u[:, i]
        outs.append(tssm.paged_decode_mamba_layer(
            t, tp, x, cache, torch.tensor([False, True]))[1:])
    _close(torch.cat(outs, dim=1), want.numpy())


# -------------------------------------------------------- gated_rmsnorm ----

@pytest.mark.parametrize("rows", [1, 8, 64, 256])
def test_gated_rmsnorm_plain_matches_jax_ref_and_pallas(rows):
    rng = np.random.default_rng(rows)
    c = 128
    y = rng.normal(size=(rows, c)).astype(np.float32)
    z = (2 * rng.normal(size=(rows, c))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (c,)).astype(np.float32)
    got = ln_ref.gated_rmsnorm(_t(y), _t(z), _t(scale))
    args = [jnp.asarray(a) for a in (y, z, scale)]
    _close(got, jln_ref.gated_rmsnorm(*args))
    _close(got, jax.jit(lambda *a: jln_kernel.gated_rmsnorm(
        *a, interpret=True))(*args))
    # the wrapper takes the plain version for CPU tensors, counts nothing
    n = ln_ops.LAUNCHES["gated_rmsnorm"]
    assert torch.equal(ln_ops.gated_rmsnorm(_t(y), _t(z), _t(scale)), got)
    assert ln_ops.LAUNCHES["gated_rmsnorm"] == n


def _bf16_ulp(a):
    mag = np.maximum(np.abs(a), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _round_bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).bfloat16().double().numpy()


def test_gated_rmsnorm_plain_in_bf16_rounds_the_gate_three_times():
    """bf16: the gate rounds in the model dtype at sigmoid, z * s and
    y * g (a correctly rounded sigmoid, as PyTorch's), then the norm runs
    in fp32. The port's gated product is bitwise a float64 evaluation of
    that sequence rounded at the same three places, and its output lies
    within 1 bf16 ulp of the float64 norm of it."""
    rng = np.random.default_rng(31)
    rows, c = 8, 256
    y = torch.from_numpy(rng.normal(size=(rows, c)).astype(np.float32)
                         ).bfloat16()
    z = torch.from_numpy((2 * rng.normal(size=(rows, c))).astype(np.float32)
                         ).bfloat16()
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, (c,)).astype(np.float32)
                             ).bfloat16()
    got = ln_ref.gated_rmsnorm(y, z, scale).float().numpy()
    z64, y64 = z.double().numpy(), y.double().numpy()
    s = _round_bf16(1.0 / (1.0 + np.exp(-z64)))
    p = _round_bf16(y64 * _round_bf16(z64 * s))
    np.testing.assert_array_equal((y * (z * torch.sigmoid(z))).double(), p)
    exact = p / np.sqrt((p ** 2).mean(-1, keepdims=True) + 1e-5) * \
        scale.double().numpy()
    assert (np.abs(got - exact) <= _bf16_ulp(exact)).all()


def test_jax_bf16_sigmoid_on_the_cpu_is_not_correctly_rounded():
    """Pins why the bf16 test above has a float64 yardstick and not JAX's
    reference: XLA on the CPU computes the bf16 sigmoid in bf16 steps, up
    to 2 bf16 ulps from the correctly rounded value (PyTorch's is exact),
    which moves JAX's gated_rmsnorm outputs by up to 2 ulps of the row's
    largest output."""
    z = torch.from_numpy((2 * np.random.default_rng(31).normal(
        size=(8, 256))).astype(np.float32)).bfloat16()
    exact = _round_bf16(1.0 / (1.0 + np.exp(-z.double().numpy())))
    np.testing.assert_array_equal(torch.sigmoid(z).double().numpy(), exact)
    js = np.asarray(jax.nn.sigmoid(jnp.asarray(z.float().numpy()).astype(
        jnp.bfloat16)).astype(jnp.float32)).astype(np.float64)
    off = np.abs(js - exact) / _bf16_ulp(exact)
    assert 0 < off.max() <= 2.0


def test_gated_rmsnorm_wrapper_reads_a_strided_z():
    """z is a column slice of the in_proj output; on the CPU the wrapper
    takes it as is (the card's wrapper passes its row stride)."""
    rng = np.random.default_rng(2)
    proj = _t(rng.normal(size=(3, 5, 72)))
    y = _t(rng.normal(size=(3, 5, 32)))
    scale = _t(rng.uniform(0.5, 1.5, (32,)))
    z = proj[..., :32]
    assert not z.is_contiguous()
    assert torch.equal(ln_ops.gated_rmsnorm(y, z, scale),
                       ln_ref.gated_rmsnorm(y, z.contiguous(), scale))
    with pytest.raises(ValueError, match="unsupported device"):
        ln_ops.gated_rmsnorm(y.to("meta"), z.to("meta"), scale.to("meta"))


# ------------------------------------------------------------- on a card ----

@pytest.mark.gpu
@pytest.mark.parametrize("c", [4096, 8192])
@pytest.mark.parametrize("rows", [1, 8, 64, 300])
def test_gated_rmsnorm_kernel_matches_plain_on_card(rows, c):
    """The kernel at the mamba2 width C = 4096 and jamba's 8192, z read in
    place from a [rows, 2 C + 320] in_proj row: within 1 bf16 ulp of the
    row's largest output of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card (sm_90a)")
    g = torch.Generator(device="cuda").manual_seed(rows)
    proj = torch.randn((rows, 2 * c + 320), generator=g,
                       device="cuda").bfloat16()
    y = torch.randn((rows, c), generator=g, device="cuda").bfloat16()
    scale = (1 + 0.1 * torch.randn((c,), generator=g, device="cuda")
             ).bfloat16()
    z = proj[:, :c]
    n = ln_ops.LAUNCHES["gated_rmsnorm"]
    out = ln_ops.gated_rmsnorm(y, z, scale)
    assert ln_ops.LAUNCHES["gated_rmsnorm"] == n + 1
    plain = ln_ref.gated_rmsnorm(y, z, scale).float()
    row_max = plain.abs().amax(dim=-1, keepdim=True).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(row_max)) - 7)
    assert bool(((out.float() - plain).abs() <= ulp).all())
