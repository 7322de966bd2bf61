"""Flash attention: the port's plain version against the JAX Pallas kernel
(interpret mode, as ``tests/test_attention.py`` runs it) on the same numpy
inputs, fp32 within 2e-5 and bf16 within 1 bf16 ulp of the largest
|output|; the wrapper's CPU dispatch; ragged lengths (which the Pallas
kernel rejects) against the port's own naive attention; the chunked
attention against JAX's; ``attention_core``'s routing; the kernel's work
order (built on the host); and, on a card only, the CUDA kernel against the
plain version, at D 128 and 64 and on column views of one QKV tensor."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jkernel
from repro.kernels.flash_attention import ops as jops
from repro.models import attention as jattn
from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import attention as attn

torch.set_num_threads(2)

ATOL = 2e-5


def _qkv(seed, b, sq, sk, hq, hkv, d, dtype=np.float32):
    """Model layout: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D]."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, d)).astype(dtype),
            rng.normal(size=(b, sk, hkv, d)).astype(dtype),
            rng.normal(size=(b, sk, hkv, d)).astype(dtype))


def _bf16_ulp_tol(out: np.ndarray, ulps: float = 1.0) -> float:
    """``ulps`` bf16 units in the last place (8 significant bits) at the
    largest |output|."""
    top = float(np.abs(out).max())
    return ulps * 2.0 ** (np.floor(np.log2(top)) - 7)


def _port(q, k, v, kv_len, dtype=torch.float32, **kw):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    lens = None if kv_len is None else torch.as_tensor(kv_len,
                                                       dtype=torch.int32)
    return ops.flash_attention(*t, kv_len=lens, **kw).float().numpy()


def _pallas(q, k, v, kv_len, dtype=jnp.float32, **kw):
    j = [jnp.asarray(a, dtype) for a in (q, k, v)]
    lens = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    return np.asarray(jops.flash_attention(*j, kv_len=lens, interpret=True,
                                           **kw).astype(jnp.float32))


# (causal, q_offset, window, kv_len, hq, hkv, d, sq, sk): lengths the Pallas
# kernel accepts (Sq a multiple of min(128, Sq), Sk of block_kv 64)
CASES = [
    (True, 0, 0, None, 4, 4, 32, 128, 128),
    (False, 0, 0, [100, 128], 4, 2, 64, 128, 128),
    (False, 0, 0, [0, 77], 4, 1, 32, 64, 192),
    (True, 0, 48, None, 4, 2, 64, 128, 128),
    (True, 64, 0, [192, 150], 4, 4, 32, 128, 192),
    (True, 128, 40, [256, 0], 8, 2, 64, 128, 256),
]


@pytest.mark.parametrize("case", CASES, ids=[
    "causal", "kvlen_g2", "kvlen0_g4", "window", "offset", "offset_window"])
def test_plain_flash_matches_pallas_fp32(case):
    causal, off, win, kv_len, hq, hkv, d, sq, sk = case
    q, k, v = _qkv(1, 2, sq, sk, hq, hkv, d)
    kw = dict(causal=causal, q_offset=off, window=win, block_kv=64)
    np.testing.assert_allclose(_port(q, k, v, kv_len, **kw),
                               _pallas(q, k, v, kv_len, **kw), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[5]],
                         ids=["causal", "kvlen0_g4", "offset_window"])
def test_plain_flash_matches_pallas_bf16(case):
    """bf16 in and out, fp32 inside on both sides: the two sum in other
    orders, so an output may round to the neighbouring bf16 value."""
    causal, off, win, kv_len, hq, hkv, d, sq, sk = case
    q, k, v = _qkv(2, 2, sq, sk, hq, hkv, d)
    kw = dict(causal=causal, q_offset=off, window=win, block_kv=64)
    pallas = _pallas(q, k, v, kv_len, jnp.bfloat16, **kw)
    np.testing.assert_allclose(_port(q, k, v, kv_len, torch.bfloat16, **kw),
                               pallas, atol=_bf16_ulp_tol(pallas), rtol=0)


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 96, 200, 4, 2, 32))
    lens = torch.tensor([150, 0], dtype=torch.int32)
    ops.LAUNCHES["flash_attention"] = 0
    out = ops.flash_attention(q, k, v, causal=False, kv_len=lens,
                              block_kv=64)
    plain = ref.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), lens, causal=False,
                                    block_kv=64).transpose(1, 2)
    assert torch.equal(out, plain)
    assert ops.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("length", [96, 200])
def test_plain_flash_takes_ragged_lengths(length, causal):
    """Sq = Sk not a multiple of the tile (the Pallas kernel asserts on
    these): against the port's naive attention, a kv_len = 0 row included
    (both give the mean of V over all keys there)."""
    q, k, v = (torch.from_numpy(a)
               for a in _qkv(4, 3, length, length, 4, 2, 32))
    lens = torch.tensor([length, length - 37, 0], dtype=torch.int32)
    out = ops.flash_attention(q, k, v, causal=causal, kv_len=lens,
                              block_kv=64)
    naive = attn.naive_attention(q, k, v, causal=causal, kv_len=lens)
    np.testing.assert_allclose(out.numpy(), naive.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("length", [96, 200])
def test_jax_flash_kernel_asserts_on_a_ragged_length(length):
    """A fault of the reference: ``flash_attention_fwd`` asserts Sq and Sk
    are multiples of its tiles, and ``attention_core`` passes
    ``block_kv = attn_chunk``, so on a TPU a flash prefill of a prompt that
    is not a multiple of the tiles fails there. The port takes any length
    (``test_plain_flash_takes_ragged_lengths``)."""
    q, k, v = (jnp.asarray(a).transpose(0, 2, 1, 3)
               for a in _qkv(5, 1, length, length, 4, 2, 32))
    with pytest.raises(AssertionError):
        jkernel.flash_attention_fwd(q, k, v, jnp.full((1,), length,
                                                      jnp.int32),
                                    causal=True, block_kv=64,
                                    interpret=True)


@pytest.mark.parametrize("sk,kv_len,window", [(200, None, 0),
                                              (256, [256, 31], 0),
                                              (150, [120, 150], 32)])
def test_chunked_attention_matches_jax(sk, kv_len, window):
    """The forward of the chunked online softmax, K/V padded to a chunk
    multiple (sk 200, 150) and the tail masked, fp32."""
    q, k, v = _qkv(6, 2, 48, sk, 4, 2, 32)
    kw = dict(causal=True, chunk=64, q_offset=sk - 48, window=window)
    lens_t = None if kv_len is None else torch.as_tensor(kv_len)
    lens_j = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    out = attn.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 kv_len=lens_t, **kw)
    want = jattn.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   kv_len=lens_j, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_naive_attention_window_matches_jax():
    q, k, v = _qkv(7, 2, 40, 40, 4, 2, 32)
    out = attn.naive_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=True, window=9)
    want = jattn.naive_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 causal=True, window=9)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("impl,sq,sk,want", [
    ("naive", 100, 100, "naive"),
    ("chunked", 64, 64, "naive"),        # Sk <= attn_chunk
    ("flash", 64, 64, "naive"),
    ("flash", 1, 100, "naive"),          # one query: decode
    ("chunked", 1, 100, "naive"),
    ("chunked", 100, 100, "chunked"),
    ("flash", 100, 100, "flash"),
    ("flash", 30, 100, "flash"),
])
def test_attention_core_routes_as_jax(monkeypatch, impl, sq, sk, want):
    """The rules of ``repro.models.attention.attention_core``: naive for
    ``attn_impl == "naive"``, Sk <= attn_chunk (64 at smoke size) or a
    single query; else chunked, or the flash wrapper with block_kv =
    attn_chunk. The result equals JAX's (whose flash runs the chunked path
    on the CPU) in fp32."""
    arch = dataclasses.replace(smoke_config("llama3.2-3b"), attn_impl=impl)
    calls = []

    def spy(name, fn):
        def run(*a, **kw):
            calls.append((name, kw.get("chunk", kw.get("block_kv"))))
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(attn, "naive_attention",
                        spy("naive", attn.naive_attention))
    monkeypatch.setattr(attn, "chunked_attention",
                        spy("chunked", attn.chunked_attention))
    monkeypatch.setattr(ops, "flash_attention",
                        spy("flash", ops.flash_attention))
    q, k, v = _qkv(8, 2, sq, sk, 4, 2, 32)
    lens = np.asarray([sk, sk - 11], np.int32)
    causal = sq == sk
    out = attn.attention_core(arch, *(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, kv_len=torch.from_numpy(lens))
    assert [c[0] for c in calls] == [want]
    if want != "naive":
        assert calls[0][1] == arch.attn_chunk
    from repro.configs import smoke_config as jax_smoke_config
    jarch = dataclasses.replace(jax_smoke_config("llama3.2-3b"),
                                attn_impl=impl)
    jout = jattn.attention_core(jarch, *(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal, kv_len=jnp.asarray(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)


def _rows_tiles(q0, sq, sk, kvl, causal, q_offset, window):
    """The kernel's key-tile range for one query tile, row by row (no
    shortcut): the union of the rows' bands, or every tile when a row's
    band is empty."""
    lo_min, hi_max, empty = sk, 0, False
    for r in range(q0, min(q0 + ops.BQ, sq)):
        pos = r + q_offset
        hi = min(kvl, pos + 1) if causal else kvl
        lo = max(0, pos - window + 1) if window > 0 else 0
        if lo >= hi:
            empty = True
        else:
            lo_min, hi_max = min(lo_min, lo), max(hi_max, hi)
    if empty:
        return 0, -(-sk // ops.BK)
    return lo_min // ops.BK, -(-hi_max // ops.BK)


# (B, Hq, Sq, Sk, causal, q_offset, window, kv_len): the order is built from
# the masks alone; the lengths check ``key_tiles``, which the kernel runs
# with each batch row's own length
ORDER_CASES = {
    "causal": (2, 6, 1000, 1000, True, 0, 0, None),
    "window": (3, 4, 900, 1500, True, 600, 300, None),
    "kv_len": (4, 3, 256, 4096, False, 0, 0, [4096, 3001, 0, 1777]),
    "kv_len_causal_offset": (3, 2, 700, 1200, True, -40, 0, [1200, 555, 90]),
    "kv_len_window": (2, 4, 600, 900, True, 0, 500, [900, 60]),
}


@pytest.mark.parametrize("name", list(ORDER_CASES))
def test_work_order_covers_every_item_once_heaviest_first(name):
    """The persistent kernel's work list, as the wrapper builds it: every
    (query tile, batch, head) exactly once; query tiles in non-increasing
    order of the key tiles the kernel visits for them with every key
    valid, counted row by row; the Hq heads of a (tile, batch) group next
    to each other, in order (neighbours share a KV head); and the closed
    form of ``key_tiles`` equal to the row-by-row range at Sk and at each
    batch row's length."""
    b, hq, sq, sk, causal, off, win, lens = ORDER_CASES[name]
    order = ops.work_order(b, hq, sq, sk, causal=causal, q_offset=off,
                           window=win)
    n_qt = -(-sq // ops.BQ)
    assert order.dtype == np.int32
    assert sorted(order.tolist()) == list(range(n_qt * b * hq))
    weights = []
    for i in range(0, len(order), hq):
        group = order[i:i + hq]
        qt, bi = group[0] // (b * hq), group[0] % (b * hq) // hq
        assert group.tolist() == [qt * b * hq + bi * hq + h
                                  for h in range(hq)]
        for kvl in {sk, *(lens or ())}:
            kvl = min(max(kvl, 0), sk)
            assert ops.key_tiles(qt * ops.BQ, sq, sk, kvl, causal=causal,
                                 q_offset=off, window=win) == \
                _rows_tiles(qt * ops.BQ, sq, sk, kvl, causal, off, win)
        lo, hi = _rows_tiles(qt * ops.BQ, sq, sk, sk, causal, off, win)
        weights.append(hi - lo)
    assert weights == sorted(weights, reverse=True)
    assert weights[0] > weights[-1] or not causal


# ------------------------------------------------------------- on a card ----

CARD_CASES = [c[:6] + (128,) + c[7:] for c in CASES] + [
    (True, 0, 0, [300, 171], 4, 4, 64, 300, 300),      # D 64 (bert-large)
    (True, 0, 0, [260, 199], 6, 2, 128, 260, 260),     # strided views
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES, ids=[
    "causal", "kvlen_g2", "kvlen0_g4", "window", "offset", "offset_window",
    "d64", "strided"])
def test_flash_kernel_matches_plain_on_card(case):
    """bf16 kernel vs the plain version in fp32 on the same bf16 inputs:
    each query row within 2 bf16 ulps of its own largest output (rows that
    average many keys are small; a whole-tensor gate would miss a wrong
    late tile there); one launch counted. The last case reads q, k and v
    as column views of one [B, S, (Hq + 2 Hkv) D] tensor, as
    ``qkv_project`` gives them (the TMA descriptors' strides)."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card (sm_90a)")
    causal, off, win, kv_len, hq, hkv, d, sq, sk = case
    if case is CARD_CASES[-1]:
        rng = np.random.default_rng(9)
        qkv = torch.from_numpy(rng.normal(size=(2, sq, (hq + 2 * hkv) * d))
                               .astype(np.float32)).cuda().to(torch.bfloat16)
        q = qkv[..., :hq * d].unflatten(-1, (hq, d))
        k = qkv[..., hq * d:(hq + hkv) * d].unflatten(-1, (hkv, d))
        v = qkv[..., (hq + hkv) * d:].unflatten(-1, (hkv, d))
    else:
        q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16)
                   for a in _qkv(9, 2, sq + 3, sk + 5, hq, hkv, d))
    lens = None if kv_len is None else torch.tensor(kv_len, device="cuda",
                                                     dtype=torch.int32)
    n = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, q_offset=off,
                              kv_len=lens, window=win, block_kv=64)
    assert ops.LAUNCHES["flash_attention"] == n + 1
    plain = ops.flash_attention(q.float().cpu(), k.float().cpu(),
                                v.float().cpu(), causal=causal, q_offset=off,
                                kv_len=None if lens is None else lens.cpu(),
                                window=win, block_kv=64).numpy()
    out = out.float().cpu().numpy()
    top = np.maximum(np.abs(plain).max(-1), np.finfo(np.float32).tiny)
    tol = 2.0 * 2.0 ** (np.floor(np.log2(top)) - 7)
    err = np.abs(out - plain).max(-1)
    assert (err <= tol).all(), float((err / tol).max())
