"""Sampling: the port's threefry ``row_uniforms`` bitwise against JAX, the
top-k/top-p filter's plain versions against the JAX Pallas kernel
(interpret mode) and the JAX sort-based oracle, the inverse-CDF draw and
``sample_tokens`` against JAX, the wrappers' CPU dispatch, and on a card the
CUDA filter and draw kernels bitwise against their plain versions."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.fused_lm_head import ref as jhead
from repro.kernels.fused_sampling import kernel as jkernel
from repro.kernels.fused_sampling import ref as jsref
from repro.serving.sampling import sample_tokens as jax_sample_tokens
from repro_torch.kernels.fused_lm_head import ref as head
from repro_torch.kernels.fused_sampling import ops, ref as sref
from repro_torch.serving.sampling import SamplingParams, sample_tokens

torch.set_num_threads(2)


def test_row_uniforms_bitwise_match_jax():
    seeds = np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint64)
    s, p = np.meshgrid(seeds, np.arange(4096), indexing="ij")
    s, p = s.ravel(), p.ravel()
    want = np.asarray(jhead.row_uniforms(jnp.asarray(s.astype(np.uint32)),
                                         jnp.asarray(p.astype(np.int32))))
    got = head.row_uniforms(torch.from_numpy(s.astype(np.int64)),
                            torch.from_numpy(p.astype(np.int64))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got >= 0).all() and (got < 1).all()


def _rows(seed, s, v, scale=3.0):
    rng = np.random.default_rng(seed)
    lg = (rng.normal(size=(s, v)) * scale).astype(np.float32)
    lg[1, :7] = lg[1, 7]                          # ties at the k-th value
    lg[2, ::3] = -np.inf                          # pre-masked entries
    lg[3] = -np.inf                               # fully masked row
    top_k = np.array([40, 5, 0, 3, 1, 0, v + 9, 17][:s], np.int32)
    top_p = np.array([0.9, 1.0, 0.5, 0.9, 0.3, 0.95, 0.8, 1.0][:s],
                     np.float32)
    return lg, top_k, top_p


def _nucleus_margin(lg, top_k, top_p, row):
    """|SG - T| at the JAX oracle's nucleus boundary of one row, over Z."""
    lg_r, tk, tp = (jnp.asarray(lg[row:row + 1]), jnp.asarray(top_k[row:row + 1]),
                    jnp.asarray(top_p[row:row + 1]))
    k_only = np.asarray(jsref.filter_logits_ref(lg_r, tk, jnp.ones_like(tp)))
    u, z = jsref.softmax_mass_stats(jnp.asarray(k_only))
    t = float(jsref.nucleus_target(tp, z)[0])
    vals = np.unique(k_only[np.isfinite(k_only)])
    sg = [float(jsref.strict_greater_mass(jnp.asarray(k_only), u,
                                          jnp.asarray([v], jnp.float32))[0])
          for v in vals]
    return min(abs(x - t) for x in sg) / max(float(z[0]), 1e-30)


@pytest.mark.parametrize("seed,v", [(0, 512), (1, 1000), (2, 128256 // 64)])
def test_filter_plain_matches_pallas_and_oracle(seed, v):
    lg, top_k, top_p = _rows(seed, 8, v)
    t_args = (torch.from_numpy(lg), torch.from_numpy(top_k),
              torch.from_numpy(top_p))
    bisect = sref.filter_logits_bisect(*t_args).numpy()
    oracle = sref.filter_logits_ref(*t_args).numpy()
    np.testing.assert_array_equal(bisect.view(np.int32), oracle.view(np.int32))
    j_args = (jnp.asarray(lg), jnp.asarray(top_k), jnp.asarray(top_p))
    pallas = np.asarray(jkernel.filter_logits(*j_args, interpret=True))
    j_oracle = np.asarray(jsref.filter_logits_ref(*j_args))
    for want in (pallas, j_oracle):
        for row in range(lg.shape[0]):
            if np.array_equal(np.isfinite(bisect[row]), np.isfinite(want[row])):
                np.testing.assert_array_equal(
                    bisect[row][np.isfinite(bisect[row])],
                    want[row][np.isfinite(want[row])])
                continue
            margin = _nucleus_margin(lg, top_k, top_p, row)
            print(f"row {row}: masks differ; nucleus-boundary margin "
                  f"|SG - T| / Z = {margin:.3e}")
            assert margin < 1e-6, (row, margin)


def test_canonical_tiled_sum_is_a_halving_tree_and_left_fold():
    x = torch.from_numpy(np.random.default_rng(3).random((2, 300),
                                                         np.float32))
    parts = sref.tile_partial_sums(x)
    assert parts.shape == (2, 3)
    tile = np.zeros((2, 384), np.float32)
    tile[:, :300] = x.numpy()
    for t in range(3):
        y = tile[:, t * 128:(t + 1) * 128]
        while y.shape[1] > 1:
            h = y.shape[1] // 2
            y = y[:, :h] + y[:, h:]
        np.testing.assert_array_equal(parts[:, t].numpy(), y[:, 0])
    acc = np.zeros((2,), np.float32)
    for t in range(3):
        acc = (acc + parts[:, t].numpy()).astype(np.float32)
    np.testing.assert_array_equal(sref.tiled_row_sum(x).numpy(), acc)


def test_bit_keys_are_monotone_and_invertible():
    f = np.array([-np.inf, -3.5, -0.0, 0.0, 1e-40, 2.0, np.inf], np.float32)
    k = sref.float_to_key(torch.from_numpy(f))
    assert (k[1:] > k[:-1]).all()
    back = sref.key_to_float(k).numpy()
    np.testing.assert_array_equal(back.view(np.uint32), f.view(np.uint32))
    want = np.asarray(jsref.float_to_key(jnp.asarray(f))).astype(np.int64)
    np.testing.assert_array_equal(k.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draw_tokens_matches_jax(seed):
    rng = np.random.default_rng(seed)
    lg = (rng.normal(size=(6, 700)) * 2).astype(np.float32)
    lg[2, 100:] = -np.inf
    lg[4] = -np.inf                                 # all masked -> token 0
    rs = rng.random(6).astype(np.float32)
    rs[5] = 0.0
    want = np.asarray(jhead.draw_tokens(jnp.asarray(lg), jnp.asarray(rs)))
    got = head.draw_tokens(torch.from_numpy(lg), torch.from_numpy(rs)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[4] == 0


def test_draw_tokens_prefix_is_tile_fold_plus_sequential_lane_sum():
    rng = np.random.default_rng(7)
    lg = (rng.normal(size=(5, 300)) * 2).astype(np.float32)
    rs = rng.random(5).astype(np.float32)
    got = head.draw_tokens(torch.from_numpy(lg), torch.from_numpy(rs)).numpy()
    u = np.zeros((5, 384), np.float32)
    u[:, :300] = np.exp(lg - lg.max(-1, keepdims=True))
    parts = sref.tile_partial_sums(torch.from_numpy(u)).numpy()
    for r in range(5):
        z = np.float32(0)
        for p in parts[r]:
            z = np.float32(z + p)
        target = np.float32(rs[r] * z)
        acc, want = np.float32(0), 0
        for t in range(3):
            c = np.float32(0)
            for j in range(128):
                c = np.float32(c + u[r, t * 128 + j])
                if np.float32(acc + c) > target:
                    want = t * 128 + j
                    break
            else:
                acc = np.float32(acc + parts[r, t])
                continue
            break
        assert got[r] == want, (r, got[r], want)


@pytest.mark.parametrize("filtered,fused", [(False, True), (True, True),
                                            (True, False)])
def test_sample_tokens_matches_jax(filtered, fused):
    rng = np.random.default_rng(4)
    s, v = 8, 512
    logits = (rng.normal(size=(s, v)) * 2).astype(np.float32)
    seeds = np.array([0, 1, 7, 2 ** 31, 2 ** 32 - 1, 5, 5, 9], np.uint64)
    pos = rng.integers(0, 4096, s).astype(np.int32)
    temps = np.array([0, 0.8, 1.0, 1.3, 0.5, 0, 0.9, 2.0], np.float32)
    top_k = np.array([0, 40, 5, 0, 1, 0, 20, 100], np.int32)
    top_p = np.array([1, 0.9, 1, 0.7, 1, 1, 0.95, 0.5], np.float32)
    want = np.asarray(jax_sample_tokens(
        jnp.asarray(logits), jnp.asarray(seeds.astype(np.uint32)),
        jnp.asarray(pos), jnp.asarray(temps), jnp.asarray(top_k),
        jnp.asarray(top_p), filtered=filtered, fused=fused))
    got = sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(seeds.astype(np.int64)),
        torch.from_numpy(pos), torch.from_numpy(temps),
        torch.from_numpy(top_k), torch.from_numpy(top_p), filtered=filtered,
        fused=fused).numpy()
    np.testing.assert_array_equal(got, want)
    greedy = logits.argmax(-1)
    assert (got[temps == 0] == greedy[temps == 0]).all()


def test_sampling_params_validate_like_jax():
    for bad in (dict(temperature=-1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5), dict(seed=2 ** 32)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    sp = SamplingParams(temperature=0.8, top_k=40)
    assert not sp.greedy and sp.filtered
    assert SamplingParams().greedy and not SamplingParams().filtered


def test_filter_wrapper_takes_plain_path_on_cpu():
    ops.LAUNCHES["filter_logits"] = 0
    lg, top_k, top_p = _rows(5, 4, 256)
    args = (torch.from_numpy(lg), torch.from_numpy(top_k),
            torch.from_numpy(top_p))
    assert torch.equal(ops.filter_logits(*args),
                       sref.filter_logits_bisect(*args))
    assert ops.LAUNCHES["filter_logits"] == 0


def test_draw_wrapper_takes_plain_path_on_cpu():
    ops.LAUNCHES["draw_tokens"] = 0
    lg, _, _ = _rows(8, 4, 256)
    rs = torch.tensor([0.1, 0.5, 0.9, 0.0])
    assert torch.equal(ops.draw_tokens(torch.from_numpy(lg), rs),
                       head.draw_tokens(torch.from_numpy(lg), rs))
    assert ops.LAUNCHES["draw_tokens"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("v", [128256, 1000])
def test_filter_kernel_bitwise_matches_plain_on_card(v):
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card (sm_90a)")
    lg, top_k, top_p = _rows(6, 8, v)
    args = [torch.from_numpy(a).cuda() for a in (lg, top_k, top_p)]
    n = ops.LAUNCHES["filter_logits"]
    out = ops.filter_logits(*args)
    assert ops.LAUNCHES["filter_logits"] == n + 1
    plain = sref.filter_logits_bisect(*args)
    assert torch.equal(out.view(torch.int32), plain.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("v", [128256, 1000])
def test_draw_kernel_bitwise_matches_plain_on_card(v):
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card (sm_90a)")
    lg, top_k, top_p = _rows(9, 8, v)
    args = [torch.from_numpy(a).cuda() for a in (lg, top_k, top_p)]
    lg_f = sref.filter_logits_bisect(*args)
    rs = torch.from_numpy(np.random.default_rng(9).random(8)
                          .astype(np.float32)).cuda()
    n = ops.LAUNCHES["draw_tokens"]
    out = ops.draw_tokens(lg_f, rs)
    assert ops.LAUNCHES["draw_tokens"] == n + 1
    assert torch.equal(out, head.draw_tokens(lg_f, rs))
