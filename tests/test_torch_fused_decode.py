"""Fused decode in the port: the fused add + norm and the fused LM head
against the JAX package, and the fused engine against the port's unfused
engine and the JAX engine.

- ``decode_residual_norm``: the plain version against the JAX ref and the
  Pallas kernel (interpret mode) on the same numpy inputs: x + y bitwise,
  the norm within 1e-6 (fp32) or 1 bf16 ulp (bf16) of each output. In bf16
  layernorm + bias, XLA on the CPU rounds inside the norm (its outputs lie
  up to 2 ulps from a float64 evaluation, the port's within 1), so there
  the bound is 1 bf16 ulp of the row's largest output, and the port is
  also held within 1 ulp of each output of the float64 evaluation.
- ``head_tokens``: the plain version against the JAX Pallas kernel
  (interpret) and the JAX streaming path on inputs whose GEMM is exact in
  any order, so tokens and the finite probe are bitwise; the epilogue
  corners of the JAX tests (fully masked row, -inf entries, no-op filters,
  k-th value ties across a tile edge); and bit equality with the port's
  unfused sampler.
- The engine: fused streams bitwise equal to the port's unfused engine and
  equal to the JAX ``fused_decode=True`` engine, a divergence tolerated
  only where the JAX top-2 logit margin is below 1e-4; the environment
  default and the CLI flag.
- On a card only (``gpu`` marker): each CUDA kernel against its plain
  version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.fused_layernorm import kernel as jln_kernel
from repro.kernels.fused_layernorm import ref as jln_ref
from repro.kernels.fused_lm_head import kernel as jhead_kernel
from repro.kernels.fused_lm_head import ops as jhead_ops
from repro.kernels.fused_lm_head import ref as jhead_ref
from repro.models import build_model
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro_torch.configs import smoke_config
from repro_torch.kernels.fused_layernorm import ops as ln_ops
from repro_torch.kernels.fused_layernorm import ref as ln_ref
from repro_torch.kernels.fused_lm_head import ops as head_ops
from repro_torch.kernels.fused_lm_head import ref as head_ref
from repro_torch.launch import serve
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import Model
from repro_torch.serving import ContinuousEngine, Request, SamplingParams
from repro_torch.serving.sampling import fused_decode_enabled, sample_tokens

torch.set_num_threads(2)

MARGIN = 1e-4


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(a.astype(np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _as_dtype(a: np.ndarray, dtype: str) -> np.ndarray:
    """Round float32 values to ``dtype`` and back, so both frameworks get
    the same values."""
    return np.asarray(jnp.asarray(a).astype(dtype).astype(jnp.float32))


# ------------------------------------------------ decode_residual_norm ----

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 128), (64, 256)])
def test_decode_residual_norm_plain_matches_jax(shape, dtype, kind):
    rng = np.random.default_rng(0)
    d = shape[-1]
    y = _as_dtype(rng.normal(size=shape).astype(np.float32), dtype)
    x = _as_dtype(rng.normal(size=shape).astype(np.float32), dtype)
    scale = _as_dtype(np.linspace(0.8, 1.2, d, dtype=np.float32), dtype)
    bias = None if kind == "rmsnorm" else _as_dtype(
        np.linspace(-0.1, 0.1, d, dtype=np.float32), dtype)
    tdt = getattr(torch, dtype)
    t = [None if a is None else torch.from_numpy(a.copy()).to(tdt)
         for a in (y, x, scale, bias)]
    h, x2 = ln_ref.decode_residual_norm(*t, kind=kind)
    h, x2 = h.float().numpy(), x2.float().numpy()
    jy, jx = jnp.asarray(y).astype(dtype), jnp.asarray(x).astype(dtype)
    jb = None if bias is None else jnp.asarray(bias)
    want = [jax.jit(lambda y, x: jln_ref.decode_residual_norm(
                y, x, jnp.asarray(scale), jb, kind=kind))(jy, jx),
            jax.jit(lambda y, x: jln_kernel.decode_residual_norm(
                y, x, jnp.asarray(scale), jb, kind=kind,
                interpret=True))(jy, jx)]
    for jh, jx2 in want:
        jh = np.asarray(jh.astype(jnp.float32))
        np.testing.assert_array_equal(x2, np.asarray(jx2.astype(jnp.float32)))
        if dtype == "float32":
            np.testing.assert_allclose(h, jh, rtol=0, atol=1e-6)
        elif kind == "rmsnorm":
            assert (np.abs(h - jh) <= _bf16_ulp(jh)).all()
        else:
            row_max = np.abs(jh).max(axis=-1, keepdims=True)
            assert (np.abs(h - jh) <= _bf16_ulp(row_max)).all()
    if dtype == "bfloat16":
        x64 = x2.astype(np.float64)
        mu = x64.mean(-1, keepdims=True) if kind == "layernorm" else 0.0
        var = ((x64 - mu) ** 2).mean(-1, keepdims=True)
        exact = (x64 - mu) / np.sqrt(var + 1e-5) * scale + (
            0.0 if bias is None else bias)
        assert (np.abs(h - exact) <= _bf16_ulp(exact)).all()


def test_decode_residual_norm_plain_is_add_then_apply_norm():
    """The plain version is the unfused ``x + y`` then ``apply_norm``, so
    the fused stack equals the unfused one bit for bit on the CPU."""
    from repro_torch.models.layers import apply_norm
    g = torch.Generator().manual_seed(1)
    y, x = torch.randn(2, 3, 64, generator=g), torch.randn(2, 3, 64,
                                                           generator=g)
    p = {"scale": torch.rand(64, generator=g) + 0.5}
    h, x2 = ln_ref.decode_residual_norm(y, x, p["scale"])
    assert torch.equal(x2, x + y)
    assert torch.equal(h, apply_norm("rmsnorm", p, x + y))


# ---------------------------------------------------------- head_tokens ----

def _jit_jax_heads(x, w_dv, rs, temps, tk, tp, *, sampled, filtered):
    """(Pallas interpret, streaming) JAX heads, jit-compiled, w [D, V]."""
    args = tuple(jnp.asarray(a) for a in (x, w_dv, rs, temps, tk, tp))

    def pallas(*a):
        return jhead_kernel.head_tokens(*a, sampled=sampled, filtered=filtered,
                                        interpret=True)

    def stream(*a):
        return jhead_ops._head_tokens_jnp(*a, sampled=sampled,
                                          filtered=filtered, softcap=None,
                                          axis_name=None, tp=1)
    return [tuple(np.asarray(o) for o in jax.jit(f)(*args))
            for f in (pallas, stream)]


def _draw_keys(rng, s):
    """Seeds (uint32 values as int64) and int32 stream positions for ``s``
    rows, with JAX's uniforms of them (what the port's head derives)."""
    seeds = rng.integers(0, 2 ** 32, s, dtype=np.int64)
    pos = rng.integers(0, 4096, s).astype(np.int32)
    rs = jhead_ref.row_uniforms(jnp.asarray(seeds.astype(np.uint32)),
                                jnp.asarray(pos))
    return seeds, pos, np.asarray(rs)


# (seed, position) pairs whose uniforms are about 0.01, 0.5, 0.99, 0.33
# and 0.66 (found by a search over positions at seed 7)
PINNED_KEYS = [(7, 2426), (7, 19686), (7, 7622), (7, 2576), (7, 18206)]
PINNED_US = [0.01, 0.5, 0.99, 0.33, 0.66]


def _pinned_keys():
    """``PINNED_KEYS`` as the engines pass them, with JAX's uniforms of
    them, each within 1e-4 of its ``PINNED_US``."""
    seeds = np.array([k[0] for k in PINNED_KEYS], np.int64)
    pos = np.array([k[1] for k in PINNED_KEYS], np.int32)
    rs = np.asarray(jhead_ref.row_uniforms(
        jnp.asarray(seeds.astype(np.uint32)), jnp.asarray(pos)))
    np.testing.assert_allclose(rs, PINNED_US, rtol=0, atol=1e-4)
    return seeds, pos, rs


def _port_head(x, w_vd, seeds, pos, temps, tk, tp, *, sampled, filtered,
               dtype=torch.float32):
    tok, ok = head_ops.head_tokens(
        torch.from_numpy(x).to(dtype), torch.from_numpy(w_vd).to(dtype),
        torch.from_numpy(seeds), torch.from_numpy(pos),
        torch.from_numpy(temps), torch.from_numpy(tk), torch.from_numpy(tp),
        sampled=sampled, filtered=filtered)
    return tok.numpy(), ok.numpy()


def test_head_tokens_kth_ties_across_tile_edge_match_jax():
    """A 5-way tie at 126..130 straddles the 128-lane tile edge, top_k cuts
    inside it; identity weights inject the logits exactly. The greedy row
    takes the first tied lane."""
    v = 640
    rng = np.random.default_rng(9)
    base = rng.normal(scale=0.1, size=(6, v)).astype(np.float32)
    base[:, 126:131] = 3.0
    base[:, 255:258] = 2.5
    w = np.eye(v, dtype=np.float32)
    seeds, pos, rs = _draw_keys(rng, 6)
    temps = np.array([1.0, 0.8, 1.0, 0.0, 1.2, 1.0], np.float32)
    tk = np.array([3, 2, 6, 4, 1, 7], np.int32)
    tp = np.array([1.0, 0.95, 0.9, 1.0, 1.0, 0.8], np.float32)
    tok, ok = _port_head(base, w, seeds, pos, temps, tk, tp, sampled=True,
                         filtered=True)
    for jtok, jok in _jit_jax_heads(base, w, rs, temps, tk, tp, sampled=True,
                                    filtered=True):
        np.testing.assert_array_equal(tok, jtok)
        np.testing.assert_array_equal(ok, jok)
    assert tok[3] == 126


@pytest.mark.parametrize("sampled,filtered", [(True, True), (False, False),
                                              (True, False)])
def test_head_tokens_pinned_corners_match_jax(sampled, filtered):
    """Greedy rows mixed with sampled ones, top_p exactly 1, top_k >= V,
    top_k 1, uniforms pinned near 0.01, 0.5, 0.99, 0.33 and 0.66, bf16
    hidden and weight on dyadic grids (every partial sum of a logit exact,
    so the GEMM's order cannot move a bit)."""
    s, d, v = 5, 64, 384
    rng = np.random.default_rng(0)
    x = (rng.integers(-8, 9, (s, d)) / 8).astype(np.float32)
    w = (rng.integers(-8, 9, (v, d)) / 64).astype(np.float32)
    seeds, pos, rs = _pinned_keys()
    temps = np.array([0.0, 1.0, 0.7, 1.5, 1.0], np.float32)
    tk = np.array([0, v + 3, 1, 8, 0], np.int32)
    tp = np.array([1.0, 1.0, 0.9, 0.5, 1.0], np.float32)
    tok, ok = _port_head(x, w, seeds, pos, temps, tk, tp, sampled=sampled,
                         filtered=filtered, dtype=torch.bfloat16)
    jx = np.asarray(jnp.asarray(x, jnp.bfloat16))
    jw = np.asarray(jnp.asarray(w.T, jnp.bfloat16))
    for jtok, jok in _jit_jax_heads(jx, jw, rs, temps, tk, tp,
                                    sampled=sampled, filtered=filtered):
        np.testing.assert_array_equal(tok, jtok)
        np.testing.assert_array_equal(ok, jok)
    assert ok.all()


def _epilogue_both(logits, rs, temps, tk, tp, *, filtered=True):
    got = head_ref.head_epilogue(
        *(torch.from_numpy(a) for a in (logits, rs, temps, tk, tp)),
        sampled=True, filtered=filtered)
    want = jax.jit(lambda *a: jhead_ref.head_epilogue(
        *a, sampled=True, filtered=filtered))(
        *(jnp.asarray(a) for a in (logits, rs, temps, tk, tp)))
    got = tuple(t.numpy() for t in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    return got


def test_head_epilogue_fully_masked_row_draws_token_zero():
    v = 256
    logits = np.stack([np.full((v,), -np.inf, np.float32),
                       np.linspace(-1, 1, v, dtype=np.float32)])
    tok, ok = _epilogue_both(logits, np.array([0.7, 0.3], np.float32),
                             np.ones(2, np.float32), np.zeros(2, np.int32),
                             np.ones(2, np.float32))
    assert tok[0] == 0
    assert not ok[0] and ok[1]


def test_head_epilogue_neg_inf_entries_carry_zero_mass():
    v = 256
    rng = np.random.default_rng(3)
    base = rng.normal(size=(4, v)).astype(np.float32)
    masked = rng.random(size=(4, v)) < 0.5
    masked[:, 7] = False
    base[masked] = -np.inf
    tok, ok = _epilogue_both(base, rng.random(4).astype(np.float32),
                             np.full(4, 0.9, np.float32),
                             np.zeros(4, np.int32), np.ones(4, np.float32))
    assert not ok.any()
    for r in range(4):
        assert not masked[r, tok[r]]


def test_head_epilogue_no_op_filters_equal_unfiltered():
    v = 384
    logits = np.random.default_rng(5).normal(size=(3, v)).astype(np.float32)
    rs = np.array([0.11, 0.52, 0.93], np.float32)
    temps = np.array([0.7, 1.0, 1.3], np.float32)
    tok_f, ok_f = _epilogue_both(logits, rs, temps,
                                 np.array([v, v + 7, 0], np.int32),
                                 np.ones(3, np.float32))
    tok_u, ok_u = _epilogue_both(logits, rs, temps, np.zeros(3, np.int32),
                                 np.ones(3, np.float32), filtered=False)
    np.testing.assert_array_equal(tok_f, tok_u)
    np.testing.assert_array_equal(ok_f, ok_u)


@pytest.mark.parametrize("filtered,fused", [(False, True), (True, True),
                                            (True, False)])
def test_head_tokens_plain_equals_unfused_sampler(filtered, fused):
    """The fused head's plain version against unembed + the port's
    ``sample_tokens`` (the unfused engine's selection), bitwise."""
    from repro_torch.models.layers import unembed
    rng = np.random.default_rng(4)
    s, d, v = 8, 32, 512
    x = torch.from_numpy(rng.normal(size=(s, d)).astype(np.float32))
    emb = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32))
    seeds = torch.tensor([0, 1, 7, 2 ** 31, 2 ** 32 - 1, 5, 5, 9])
    pos = torch.from_numpy(rng.integers(0, 4096, s))
    temps = torch.tensor([0, 0.8, 1.0, 1.3, 0.5, 0, 0.9, 2.0])
    tk = torch.tensor([0, 40, 5, 0, 1, 0, 20, 100], dtype=torch.int32)
    tp = torch.tensor([1, 0.9, 1, 0.7, 1, 1, 0.95, 0.5])
    want = sample_tokens(unembed({}, x, emb), seeds, pos, temps, tk, tp,
                         filtered=filtered, fused=fused)
    tok, ok = head_ops.head_tokens(x, emb, seeds, pos, temps, tk, tp,
                                   sampled=True, filtered=filtered)
    assert torch.equal(tok, want) and ok.all()


def test_wrappers_take_plain_path_on_cpu_without_counting():
    ln_ops.LAUNCHES["decode_residual_norm"] = 0
    head_ops.LAUNCHES["head_tokens"] = 0
    g = torch.Generator().manual_seed(2)
    y, x = torch.randn(4, 64, generator=g), torch.randn(4, 64, generator=g)
    scale = torch.ones(64)
    for a, b in zip(ln_ops.decode_residual_norm(y, x, scale),
                    ln_ref.decode_residual_norm(y, x, scale)):
        assert torch.equal(a, b)
    emb = torch.randn(256, 64, generator=g)
    seeds = torch.tensor([3, 2 ** 32 - 1, 0, 17])
    pos = torch.tensor([0, 9, 2 ** 31 - 1, 40], dtype=torch.int32)
    row = (torch.tensor([0.0, 1.0, 0.5, 2.0]),
           torch.tensor([0, 5, 0, 9], dtype=torch.int32),
           torch.tensor([1.0, 0.9, 1.0, 0.5]))
    for a, b in zip(head_ops.head_tokens(x, emb, seeds, pos, *row,
                                         sampled=True, filtered=True),
                    head_ref.head_tokens(x, emb,
                                         head_ref.row_uniforms(seeds, pos),
                                         *row, sampled=True, filtered=True)):
        assert torch.equal(a, b)
    assert ln_ops.LAUNCHES["decode_residual_norm"] == 0
    assert head_ops.LAUNCHES["head_tokens"] == 0


@pytest.mark.parametrize("sampled,filtered", [(False, False), (True, False),
                                              (True, True)])
@pytest.mark.parametrize("pos_dtype", [torch.int32, torch.int64])
def test_head_tokens_seeds_and_positions_equal_the_uniforms_call(
        sampled, filtered, pos_dtype):
    """The wrapper on the CPU: seeds and positions in, token for token the
    plain head fed ``ref.row_uniforms`` of them (the head's old call)."""
    g = torch.Generator().manual_seed(6)
    x, emb = torch.randn(6, 32, generator=g), torch.randn(384, 32, generator=g)
    seeds = torch.tensor([0, 1, 2 ** 31, 2 ** 32 - 1, 77, 5])
    pos = torch.tensor([0, 3, 4095, 2 ** 31 - 1, 12, 12], dtype=pos_dtype)
    row = (torch.tensor([0.0, 0.7, 1.0, 1.3, 0.9, 2.0]),
           torch.tensor([0, 40, 0, 3, 1, 384 + 5], dtype=torch.int32),
           torch.tensor([1.0, 0.9, 0.95, 1.0, 1.0, 0.5]))
    got = head_ops.head_tokens(x, emb, seeds, pos, *row, sampled=sampled,
                               filtered=filtered)
    want = head_ref.head_tokens(x, emb, head_ref.row_uniforms(seeds, pos),
                                *row, sampled=sampled, filtered=filtered)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["seeds int32", "seeds float", "seeds [S+1]",
                                 "positions float", "positions int16",
                                 "positions [S, 1]"])
def test_head_tokens_raises_on_wrong_seeds_or_positions(bad):
    x, emb = torch.zeros(4, 32), torch.zeros(256, 32)
    keys = {"seeds": torch.arange(4), "positions": torch.arange(4).int()}
    name, what = bad.split(" ", 1)
    t = keys[name]
    keys[name] = {"int32": t.int(), "float": t.float(), "int16": t.short(),
                  "[S+1]": torch.arange(5), "[S, 1]": t[:, None]}[what]
    row = (torch.ones(4), torch.zeros(4, dtype=torch.int32), torch.ones(4))
    with pytest.raises(ValueError, match=name):
        head_ops.head_tokens(x, emb, keys["seeds"], keys["positions"], *row,
                             sampled=True, filtered=False)


# ---------------------------------------------------------------- engine ----

@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model) sharing one set of fp32 weights."""
    arch = dataclasses.replace(jax_smoke_config("llama3.2-3b"),
                               dtype="float32", param_dtype="float32")
    model = build_model(arch)
    params = model.init(jax.random.key(0))
    t_arch = dataclasses.replace(smoke_config("llama3.2-3b"),
                                 dtype="float32")
    t_model = Model(t_arch, from_jax_params(
        t_arch, jax.tree.map(np.asarray, params), device="cpu"))
    return model, params, t_model


def _top2_margin(model, params, context):
    logits = model.forward(params, {"tokens": jnp.asarray([context])})[0]
    top = np.sort(np.asarray(logits[0, -1]))[-2:]
    return float(top[1] - top[0])


def _serve_three(pair, reqs, **kw):
    """JAX fused engine, port fused engine, port unfused engine."""
    model, params, t_model = pair
    j_eng = JaxEngine(model, params, fused_decode=True, **kw)
    fused = ContinuousEngine(t_model, fused_decode=True, **kw)
    unfused = ContinuousEngine(t_model, fused_decode=False, **kw)
    assert j_eng.fused_decode and fused.fused_decode
    j_res = j_eng.run([JaxRequest(
        uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
        eos_id=r.eos_id, sampling=JaxSampling(**dataclasses.asdict(r.sampling)))
        for r in reqs])
    return (j_eng, fused, unfused), (j_res, fused.run(reqs),
                                     unfused.run(reqs))


def _assert_streams(pair, reqs, j_res, f_res, u_res):
    model, params, _ = pair
    for r in reqs:
        assert f_res[r.uid]["tokens"] == u_res[r.uid]["tokens"], r.uid
        a, b = j_res[r.uid]["tokens"], f_res[r.uid]["tokens"]
        if a == b:
            continue
        step = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b)))
        margin = _top2_margin(model, params, list(r.prompt) + a[:step])
        print(f"request {r.uid} diverged at step {step}: JAX top-2 logit "
              f"margin {margin:.3e}")
        assert margin < MARGIN, (r.uid, step, margin, a, b)


def _prompts(seed, n, lo, hi, vocab=512):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(5, vocab, rng.integers(lo, hi))))
            for _ in range(n)]


def test_fused_greedy_streams_match_unfused_and_jax(pair):
    prompts = _prompts(3, 4, 6, 14)
    gens = [6, 11, 4, 9]
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=gens[i])
            for i in range(4)]
    engines, res = _serve_three(pair, reqs, num_slots=4, num_pages=48,
                                page_size=8, max_seq_len=64)
    _assert_streams(pair, reqs, *res)
    assert engines[1].live_kv_tokens == 0
    assert (engines[1].steps, engines[1].prefills) == \
        (engines[0].steps, engines[0].prefills)


@pytest.mark.parametrize("fused_sampling", [True, False])
def test_fused_seeded_sampled_streams_match_unfused_and_jax(pair,
                                                            fused_sampling):
    prompts = _prompts(5, 5, 8, 20)
    samplings = [SamplingParams(temperature=0.8, top_k=40, top_p=0.9, seed=7),
                 SamplingParams(temperature=1.0, seed=11),
                 SamplingParams(),
                 SamplingParams(temperature=0.7, top_p=0.8, seed=2 ** 32 - 1),
                 SamplingParams(temperature=1.3, top_k=5, seed=0)]
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=8,
                    sampling=samplings[i]) for i in range(5)]
    _, res = _serve_three(pair, reqs, num_slots=3, num_pages=40, page_size=8,
                          max_seq_len=48, fused_sampling=fused_sampling)
    _assert_streams(pair, reqs, *res)


def test_fused_shared_prefix_cow_trace_matches_unfused_and_jax(pair):
    rng = np.random.default_rng(21)
    prefix = list(map(int, rng.integers(5, 512, 19)))
    reqs = [Request(uid=i, prompt=prefix + list(map(
        int, rng.integers(5, 512, 4))), max_new_tokens=5 + i,
        sampling=SamplingParams(temperature=0.9, top_k=20, seed=i)
        if i % 2 else SamplingParams()) for i in range(4)]
    engines, res = _serve_three(pair, reqs, num_slots=4, num_pages=48,
                                page_size=8, max_seq_len=64,
                                prefix_cache=True)
    _assert_streams(pair, reqs, *res)
    assert engines[1].cow_copies == engines[0].cow_copies == 3


def test_fused_forced_preemption_matches_unfused_and_jax(pair):
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(5, 512, 12))) for _ in range(5)]
    gens = [4, 16, 7, 12, 9]
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=gens[i],
                    sampling=SamplingParams(temperature=0.8, top_p=0.9,
                                            seed=i) if i in (1, 3)
                    else SamplingParams()) for i in range(5)]
    engines, res = _serve_three(pair, reqs, num_slots=2, num_pages=10,
                                page_size=4, max_seq_len=32,
                                prefix_cache=False)
    _assert_streams(pair, reqs, *res)
    assert engines[1].prefills > 5
    assert engines[1].prefills == engines[0].prefills == engines[2].prefills


def test_engine_defaults_to_fused_decode_and_env_turns_it_off(pair,
                                                              monkeypatch):
    kw = dict(num_slots=2, num_pages=8, page_size=4)
    monkeypatch.delenv("REPRO_FUSED_DECODE", raising=False)
    assert fused_decode_enabled()
    eng = ContinuousEngine(pair[2], **kw)
    assert eng.fused_decode and eng.fused_decode_off_reason is None
    for off in ("0", ""):
        monkeypatch.setenv("REPRO_FUSED_DECODE", off)
        assert not fused_decode_enabled()
        assert not ContinuousEngine(pair[2], **kw).fused_decode
        assert ContinuousEngine(pair[2], fused_decode=True, **kw).fused_decode
    monkeypatch.setenv("REPRO_FUSED_DECODE", "1")
    assert not ContinuousEngine(pair[2], fused_decode=False, **kw).fused_decode


def test_fused_decode_softcap_raises_and_untied_head_falls_back():
    arch = dataclasses.replace(smoke_config("llama3.2-3b"), dtype="float32")
    g = torch.Generator().manual_seed(0)
    kw = dict(num_slots=2, num_pages=8, page_size=4)
    capped = Model(dataclasses.replace(arch, logit_softcap=30.0),
                   Model.init(arch, g, device="cpu").params)
    with pytest.raises(NotImplementedError, match="not ported"):
        ContinuousEngine(capped, fused_decode=True, **kw)
    assert not ContinuousEngine(capped, fused_decode=False, **kw).fused_decode
    untied = Model.init(dataclasses.replace(arch, tie_embeddings=False), g,
                        device="cpu")
    eng = ContinuousEngine(untied, fused_decode=True, **kw)
    # an untied head now serves fused (the head kernel reads out.head
    # [D, V] in place), with the unfused engine's stream
    assert eng.fused_decode and eng.fused_decode_off_reason is None
    reqs = [Request(uid=0, prompt=[5, 6, 7], max_new_tokens=3),
            Request(uid=1, prompt=[8, 9, 10, 11], max_new_tokens=4,
                    sampling=SamplingParams(temperature=0.9, top_k=30,
                                            seed=3))]
    res = eng.run(reqs)
    ref = ContinuousEngine(untied, fused_decode=False, **kw).run(reqs)
    assert len(res[0]["tokens"]) == 3
    for r in reqs:
        assert res[r.uid]["tokens"] == ref[r.uid]["tokens"]


def test_serve_cli_fused_decode_flag(capsys):
    base = ["--engine", "continuous", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen-len", "4",
            "--temperature", "0.8", "--top-k", "20"]
    on = serve.main(base + ["--fused-decode"])
    assert "fused decode on" in capsys.readouterr().out
    off = serve.main(base + ["--no-fused-decode"])
    assert "fused decode off" in capsys.readouterr().out
    assert on["fused_decode"] and not off["fused_decode"]
    np.testing.assert_array_equal(on["tokens"], off["tokens"])


# ------------------------------------------------------------- on a card ----

@pytest.mark.gpu
@pytest.mark.parametrize("d", [3072, 12288, 3070])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("rows", [8, 64, 300])
def test_residual_norm_kernel_matches_plain_on_card(rows, kind, d):
    """llama3.2-3b's D 3072 and mistral-large's 12288 (the register path),
    and D 3070 (the wide variant), at decode, prefill-chunk and ragged row
    counts."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card (sm_90a)")
    g = torch.Generator(device="cuda").manual_seed(rows)
    dtype = torch.bfloat16
    y = torch.randn((rows, d), generator=g, device="cuda").to(dtype)
    x = torch.randn((rows, d), generator=g, device="cuda").to(dtype)
    scale = (1 + 0.1 * torch.randn((d,), generator=g, device="cuda")).to(dtype)
    bias = (0.1 * torch.randn((d,), generator=g, device="cuda")).to(dtype) \
        if kind == "layernorm" else None
    n = ln_ops.LAUNCHES["decode_residual_norm"]
    h, x2 = ln_ops.decode_residual_norm(y, x, scale, bias, kind=kind)
    assert ln_ops.LAUNCHES["decode_residual_norm"] == n + 1
    ph, px2 = ln_ref.decode_residual_norm(y, x, scale, bias, kind=kind)
    assert torch.equal(x2, px2)
    ulp = torch.from_numpy(_bf16_ulp(ph.float().cpu().numpy())).cuda()
    assert bool(((h.float() - ph.float()).abs() <= ulp).all())


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 8, 16])
@pytest.mark.parametrize("v", [128256, 50304, 640])
def test_head_tokens_kernel_bitwise_matches_plain_on_card(v, s):
    """16 rows run the GEMV in two groups of 8 (the mma's N); one row is
    row 7 alone (top-k off, top-p 0.9: the nucleus search over the whole
    row)."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card (sm_90a)")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    d = 3072
    g = torch.Generator(device="cuda").manual_seed(v)
    w = torch.randint(-8, 9, (v, d), generator=g, device="cuda",
                      dtype=torch.int8).to(torch.bfloat16) / 64
    x = torch.randint(-8, 9, (s, d), generator=g, device="cuda",
                      dtype=torch.int8).to(torch.bfloat16) / 8
    idx = torch.arange(max(s, 8), device="cuda")
    reps = max(s // 8, 1)
    keys = (idx + 3, (idx * 11).int())
    row = (torch.tensor([0.0, 1.0, 0.8, 1.0, 0.0, 1.3, 0.7, 1.0] * reps,
                        device="cuda"),
           torch.tensor([0, 3, 40, 0, 0, 1, v + 5, 0] * reps,
                        dtype=torch.int32, device="cuda"),
           torch.tensor([1.0, 0.95, 0.95, 1.0, 1.0, 1.0, 0.5, 0.9] * reps,
                        device="cuda"))
    if s == 1:
        x, row = x[:1], tuple(t[7:8].contiguous() for t in row)
        keys = tuple(t[7:8].contiguous() for t in keys)
    rs = head_ref.row_uniforms(*keys)
    for sampled, filtered in ((False, False), (True, False), (True, True)):
        n = head_ops.LAUNCHES["head_tokens"]
        tok, ok = head_ops.head_tokens(x, w, *keys, *row, sampled=sampled,
                                       filtered=filtered)
        assert head_ops.LAUNCHES["head_tokens"] == n + 1
        ptok, pok = head_ref.head_tokens(x, w, rs, *row, sampled=sampled,
                                         filtered=filtered)
        assert torch.equal(tok, ptok) and torch.equal(ok, pok)
