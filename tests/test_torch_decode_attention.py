"""Paged attention: the port's plain versions against the JAX Pallas kernels
(interpret mode) and the JAX ``ref.py`` on the same numpy inputs, fp32,
atol 1e-5 on valid rows (seq_len > 0 for decode, rows before total_len for
prefill); the wrappers' CPU dispatch; and, on a card only, the CUDA kernels
against the plain versions."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.decode_attention import kernel as jkernel
from repro.kernels.decode_attention import ref as jref
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
                                         (8, 6, 2), (16, 24, 8)])
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
                          (16, 24, 8, 16, 7)])  # llama3.2-3b head layout
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
@pytest.mark.parametrize("seq_lens", [[576, 1, 130, 17, 0, 300, 64, 5]])
def test_decode_kernel_matches_plain_on_card(seq_lens):
    """bf16 kernel at llama3.2-3b heads vs the plain version in fp32 on the
    same bf16 inputs: each row within 2 bf16 ulps of its largest output."""
    _need_card()
    q, kp, vp, pt, sl = _decode_case(4, 8, 24, 8, 128, 16, 8 * 36 + 1, 36,
                                     seq_lens)
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
@pytest.mark.parametrize("start,valid", [(0, 64), (448, 50), (13, 3)])
def test_prefill_kernel_matches_plain_on_card(start, valid):
    _need_card()
    q, kp, vp, row = _prefill_case(5, 24, 8, 128, 16, 64, 35, 64)
    args = [t.cuda() for t in _t(q, kp, vp, row)]
    args[:3] = [t.to(torch.bfloat16) for t in args[:3]]
    out = ops.paged_prefill_attention(*args, start, start + valid)
    plain = ref.paged_prefill_attention(*[t.float() for t in args[:3]],
                                        args[3], start, start + valid)
    plain = plain[:valid].cpu().numpy()
    _assert_rows_within_ulps(out[:valid].float().cpu().numpy(), plain)
