"""Paged attention: the port's plain versions against the JAX Pallas kernels
(interpret mode) and the JAX ``ref.py`` on the same numpy inputs, fp32,
atol 1e-5 on valid rows (seq_len > 0 for decode, rows before total_len for
prefill); the wrappers' CPU dispatch, argument checks and host plan (the
cluster split and the key tiles each rank takes); and, on a card only, the
CUDA kernels against the plain versions.

The card's machine has no JAX: there the ``gpu`` tests run alone, with
``python -m pytest --noconftest -m gpu tests/test_torch_decode_attention.py``.
"""
import math

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.kernels.decode_attention import kernel as jkernel
    from repro.kernels.decode_attention import ref as jref
except ImportError:         # the card's machine: only the gpu tests run
    jnp = jkernel = jref = None
from repro_torch.kernels.decode_attention import ops, ref

torch.set_num_threads(2)

ATOL = 1e-5


def _decode_case(seed, b, hq, hkv, d, page, num_pages, max_pages, seq_lens):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    kp = rng.normal(size=(num_pages, page, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(num_pages, page, hkv, d)).astype(np.float32)
    ids = rng.permutation(np.arange(1, num_pages))[:b * max_pages]
    pt = ids.reshape(b, max_pages).astype(np.int32)
    return q, kp, vp, pt, np.asarray(seq_lens, np.int32)


def _prefill_case(seed, hq, hkv, d, page, num_pages, max_pages, chunk):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(chunk, hq, d)).astype(np.float32)
    kp = rng.normal(size=(num_pages, page, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(num_pages, page, hkv, d)).astype(np.float32)
    row = rng.permutation(np.arange(1, num_pages))[:max_pages]
    return q, kp, vp, row.astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("page,hq,hkv", [(4, 4, 1), (8, 4, 2), (16, 4, 4),
                                         (8, 6, 2), (16, 24, 8),
                                         (16, 12, 2),    # G 6 (qwen2-vl)
                                         (16, 12, 1)])   # G 12 (mistral-large)
def test_decode_plain_matches_pallas_and_jax_ref(page, hq, hkv):
    max_pages = 4
    case = _decode_case(0, 4, hq, hkv, 16, page, 20, max_pages,
                        [1, page * 2 + 3, page * max_pages, 0])
    valid = case[4] > 0
    out = ref.paged_decode_attention(*_t(*case)).numpy()
    pallas = np.asarray(jkernel.paged_decode_attention_fwd(*_j(*case),
                                                           interpret=True))
    jax_ref = np.asarray(jref.paged_decode_attention(*_j(*case)))
    np.testing.assert_allclose(out[valid], pallas[valid], atol=ATOL)
    np.testing.assert_allclose(out[valid], jax_ref[valid], atol=ATOL)


@pytest.mark.parametrize("page,hq,hkv,start,valid",
                         [(4, 4, 2, 0, 8),     # aligned, full chunk
                          (4, 4, 1, 4, 5),     # one cached page behind
                          (8, 6, 2, 3, 4),     # unaligned start (CoW tail)
                          (4, 4, 4, 8, 2),     # mostly-padded chunk
                          (16, 24, 8, 16, 7),   # llama3.2-3b head layout
                          (16, 12, 2, 5, 6),    # G 6, unaligned start
                          (16, 12, 1, 16, 3)])  # G 12, one cached page
def test_prefill_plain_matches_pallas_and_jax_ref(page, hq, hkv, start,
                                                  valid):
    chunk, max_pages = 8, 5
    q, kp, vp, row = _prefill_case(1, hq, hkv, 16, page, 24, max_pages, chunk)
    total = start + valid
    out = ref.paged_prefill_attention(*_t(q, kp, vp, row), start,
                                      total).numpy()
    pallas = np.asarray(jkernel.paged_prefill_attention_fwd(
        *_j(q, kp, vp, row), start, total, interpret=True))
    jax_ref = np.asarray(jref.paged_prefill_attention(*_j(q, kp, vp, row),
                                                      start, total))
    np.testing.assert_allclose(out[:valid], pallas[:valid], atol=ATOL)
    np.testing.assert_allclose(out[:valid], jax_ref[:valid], atol=ATOL)


def test_wrappers_take_the_plain_path_on_cpu_without_launching():
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    q, kp, vp, pt, sl = _decode_case(2, 2, 4, 2, 8, 4, 12, 2, [5, 7])
    out = ops.paged_decode_attention(*_t(q, kp, vp, pt, sl))
    assert torch.equal(out, ref.paged_decode_attention(*_t(q, kp, vp, pt,
                                                            sl)))
    q, kp, vp, row = _prefill_case(3, 4, 2, 8, 4, 12, 3, 4)
    out = ops.paged_prefill_attention(*_t(q, kp, vp, row), 2, 6)
    assert torch.equal(out, ref.paged_prefill_attention(*_t(q, kp, vp, row),
                                                        2, 6))
    assert ops.LAUNCHES == {"paged_decode_attention": 0,
                            "paged_prefill_attention": 0}


@pytest.mark.parametrize("hkv", [1, 2, 4, 8])
@pytest.mark.parametrize("b", [1, 2, 3, 8, 16, 64])
def test_decode_plan_deals_every_visible_page_to_one_rank(b, hkv):
    """The split comes from shapes alone (the lengths stay on the card):
    enough CTAs to fill the card, at most 8 a cluster; whatever a row's
    length, its key tiles, and so its pages, go to exactly one rank (the
    kernel's rank r takes tiles r, r + split, ...)."""
    max_pages, page = 36, 16
    split = ops.decode_plan(b, hkv, max_pages, page)
    assert split == ops.decode_plan.__wrapped__(b, hkv, max_pages, page)
    assert 1 <= split <= ops.MAX_SPLIT
    assert b * hkv * split >= ops.SMS or split == ops.MAX_SPLIT
    assert split == 1 or b * hkv * (split - 1) < ops.SMS   # the least
    for n in [0, 1, 15, 16, 17, 130, 300, 575, 576]:
        tiles = math.ceil(n / ops.KEY_TILE)
        dealt = [list(range(r, tiles, split)) for r in range(split)]
        assert sorted(sum(dealt, [])) == list(range(tiles))
        pages = [{t * ops.KEY_TILE // page for t in d} for d in dealt]
        for pg in range(math.ceil(n / page)):
            assert sum(pg in ps for ps in pages) == 1


@pytest.mark.parametrize("start,total,split", [(0, 64, 2), (448, 498, 8),
                                               (13, 16, 1),
                                               (4032, 4096, 8)])
def test_prefill_plan_deals_every_visible_key_to_one_rank(start, total,
                                                          split):
    """llama3.2-3b's heads, a 64-token chunk: three tiles of 64 (token,
    query head) rows a KV head, 24 clusters of 8 CTAs (the least power of
    two that fills 132 SMs) where the keys allow; each tile's keys are those
    its last row sees (no row of the tile sees more), dealt to exactly one
    rank."""
    c, hq, hkv, page = 64, 24, 8, 16
    g, max_pages = hq // hkv, math.ceil(total / page) + 1
    got = ops.prefill_plan(c, hq, hkv, start, total, page, max_pages)
    assert got == (split, 3)
    assert got == ops.prefill_plan(c, hq, hkv, start, total, page, max_pages)
    assert got[0] & (got[0] - 1) == 0 or got[0] * 2 >= math.ceil(
        total / ops.KEY_TILE)                 # a power of two, or key-bound
    for rt in range(got[1]):
        keys = ops.prefill_keys(c, g, start, total, max_pages * page, rt)
        rows = range(rt * ops.ROW_TILE, min((rt + 1) * ops.ROW_TILE, c * g))
        assert keys == max(min(start + r // g + 1, total) for r in rows)
        tiles = math.ceil(keys / ops.KEY_TILE)
        dealt = sum((list(range(r, tiles, split)) for r in range(split)),
                    [])
        assert sorted(dealt) == list(range(tiles))
        if rt == got[1] - 1:
            assert keys == total and tiles >= 2 * split or split == 1


@pytest.mark.parametrize("hq,hkv,d,page,ok", [
    (24, 8, 128, 16, True),     # llama3.2-3b, G 3
    (16, 1, 128, 16, True),     # G 16, the most
    (12, 1, 128, 8, True),      # G 12, pages of 8 rows
    (17, 1, 128, 16, False),    # G 17
    (24, 8, 64, 16, False),     # D 64
    (24, 8, 128, 4, False)])    # pages smaller than a TMA box
def test_kernel_args_take_g_up_to_16_at_head_dim_128(hq, hkv, d, page, ok):
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    q = torch.zeros((2, hq, d), dtype=torch.bfloat16)
    pool = torch.zeros((3, page, hkv, d), dtype=torch.bfloat16)
    if ok:
        ops.check_kernel_args(q, pool, pool)
    else:
        with pytest.raises(ValueError, match="head dim 128|boxes of 8"):
            ops.check_kernel_args(q, pool, pool)
    assert ops.LAUNCHES == {"paged_decode_attention": 0,
                            "paged_prefill_attention": 0}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card (sm_90a)")


def _assert_rows_within_ulps(out: np.ndarray, plain: np.ndarray,
                             ulps: float = 2.0) -> None:
    """Each query row (the last axis) within ``ulps`` bf16 units in the last
    place (8 significant bits) at that row's own largest |output|: the
    kernel's only error against an fp32 plain version is the rounding of
    its fp32 result to bf16 (half an ulp)."""
    top = np.maximum(np.abs(plain).max(-1), np.finfo(np.float32).tiny)
    tol = ulps * 2.0 ** (np.floor(np.log2(top)) - 7)
    err = np.abs(out - plain).max(-1)
    assert (err <= tol).all(), float((err / tol).max())


@pytest.mark.gpu
@pytest.mark.parametrize("g,seq_lens", [
    (1, [576, 1, 130, 17, 0, 300, 64, 5]),
    (2, [576, 1, 130, 17, 0, 300, 64, 5]),
    (3, [576, 1, 130, 17, 0, 300, 64, 5]),     # llama3.2-3b
    (6, [576, 1, 130, 17, 0, 300, 64, 5]),
    (8, [576, 1, 130, 17, 0, 300, 64, 5]),
    (12, [576, 1, 130, 17, 0, 300, 64, 5]),
    (3, [4096, 1500])])                        # a long row
def test_decode_kernel_matches_plain_on_card(g, seq_lens):
    """bf16 kernel at 8 KV heads of 128 vs the plain version in fp32 on the
    same bf16 inputs: each row within 2 bf16 ulps of its largest output,
    seq_len 0 rows exactly zero, one launch a call."""
    _need_card()
    b, max_pages = len(seq_lens), max(36, math.ceil(max(seq_lens) / 16))
    q, kp, vp, pt, sl = _decode_case(4, b, 8 * g, 8, 128, 16,
                                     b * max_pages + 1, max_pages, seq_lens)
    args = [t.cuda() for t in _t(q, kp, vp, pt, sl)]
    args[:3] = [t.to(torch.bfloat16) for t in args[:3]]
    n = ops.LAUNCHES["paged_decode_attention"]
    out = ops.paged_decode_attention(*args).float().cpu().numpy()
    assert ops.LAUNCHES["paged_decode_attention"] == n + 1
    plain = ref.paged_decode_attention(
        *[t.float() for t in args[:3]], *args[3:]).cpu().numpy()
    valid = np.asarray(seq_lens) > 0
    _assert_rows_within_ulps(out[valid], plain[valid])
    assert not np.abs(out[~valid]).any()          # seq_len 0 rows are zeros


@pytest.mark.gpu
@pytest.mark.parametrize("start,valid", [(0, 64), (448, 50), (13, 3),
                                         (4032, 64)])
def test_prefill_kernel_matches_plain_on_card(start, valid):
    """Every row of the chunk, padding rows too (they attend to the valid
    prefix), within 2 bf16 ulps of the fp32 plain version."""
    _need_card()
    max_pages = max(35, math.ceil((start + valid) / 16))
    q, kp, vp, row = _prefill_case(5, 24, 8, 128, 16, max(64, max_pages + 1),
                                   max_pages, 64)
    args = [t.cuda() for t in _t(q, kp, vp, row)]
    args[:3] = [t.to(torch.bfloat16) for t in args[:3]]
    out = ops.paged_prefill_attention(*args, start, start + valid)
    plain = ref.paged_prefill_attention(*[t.float() for t in args[:3]],
                                        args[3], start, start + valid)
    _assert_rows_within_ulps(out.float().cpu().numpy(),
                             plain.cpu().numpy())
