"""The flash attention's gradient in the port against the JAX package, at
small sizes in float32 on the CPU.

JAX's flash kernel has no VJP: on the CPU its ``attention_core`` with
``attn_impl="flash"`` runs the chunked path (``supported()`` is TPU-only),
so its flash-impl gradient is the chunked custom VJP's, and ``jax.grad``
through the Pallas kernel itself fails (pinned below). The port's flash
call is an autograd Function: the forward kernel (its plain version on the
CPU) with the rows' log-sum-exp, and JAX's chunked backward over the
forward's key tiles (``ref.flash_attention_bwd``). Held here:

- outputs and dq / dk / dv against ``jax.vjp`` of JAX's ``attention_core``
  (flash impl): causal with Sk not a multiple of the tile, a ``kv_len``
  with a 0 row (that batch row against autodiff of the port's plain
  forward instead: JAX's chunked forward averages its padded keys, and its
  backward gives such a row p = 1 for every key), a window with a
  ``q_offset``, GQA; within 1e-5 absolute / 1e-4 relative;
- the chunked VJP's gradients bitwise those of its backward before the
  backward moved into ``tiled_attention_bwd``;
- a smoke llama with ``attn_impl="flash"`` at a sequence above
  ``attn_chunk``: loss within 1e-5 relative and every gradient leaf as
  ``tests/test_torch_train_families.py`` holds them, against JAX's;
- what the Function saves (q, k, v, kv_len, the output and the lse) and
  that nothing on the flash path refuses a gradient.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.flash_attention import ops as jflash_ops
from repro.models import attention as jattn
from repro.models import build_model
from repro_torch import tree
from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tf
from repro_torch.models.convert import from_jax_params, to_jax_layout
from test_torch_training import _assert_trees_close

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
# B, Sq, Sk, Hq, Hkv, causal, q_offset, window, kv_len, tile
CASES = {
    "causal, Sk 100 over tiles of 32": (2, 100, 100, 4, 4, True, 0, 0, None,
                                        32),
    "kv_len with a 0 row": (2, 40, 100, 4, 2, False, 0, 0, [0, 77], 32),
    "window 24, q_offset 16": (2, 48, 64, 4, 4, True, 16, 24, None, 16),
    "GQA G 4, causal ragged": (1, 70, 70, 8, 2, True, 0, 0, None, 32),
}


def _inputs(spec, seed):
    b, sq, sk, hq, hkv = spec[:5]
    rng = np.random.default_rng(seed)
    d = 16
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
            for _ in range(2))
    ct = rng.normal(size=q.shape).astype(np.float32)
    return q, k, v, ct


def _archs(window, tile):
    kw = dict(attn_impl="flash", attn_chunk=tile, window=window,
              dtype="float32", param_dtype="float32")
    return (dataclasses.replace(jax_smoke_config("llama3.2-3b"), **kw),
            dataclasses.replace(smoke_config("llama3.2-3b"), **kw))


@pytest.mark.parametrize("name", list(CASES))
def test_flash_grads_match_jax_flash_impl(name):
    b, sq, sk, hq, hkv, causal, off, win, lens, tile = CASES[name]
    q, k, v, ct = _inputs(CASES[name], len(name))
    j_arch, t_arch = _archs(win, tile)
    jlens = None if lens is None else jnp.asarray(lens, jnp.int32)
    out, vjp = jax.vjp(lambda a, b_, c: jattn.attention_core(
        j_arch, a, b_, c, causal=causal, q_offset=off, kv_len=jlens),
        q, k, v)
    want = [np.asarray(w) for w in vjp(jnp.asarray(ct))]
    want_out = np.asarray(out)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tlens = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    calls = ops.LAUNCHES["flash_attention"]
    got = tattn.attention_core(t_arch, tq, tk, tv, causal=causal,
                               q_offset=off, kv_len=tlens)
    assert got.grad_fn is not None and "FlashAttn" in type(
        got.grad_fn).__name__
    assert ops.LAUNCHES["flash_attention"] == calls     # the CPU launches none
    grads = [g.numpy() for g in torch.autograd.grad(got, [tq, tk, tv],
                                                    torch.from_numpy(ct))]
    got = got.detach().numpy()
    rows = list(range(b))
    if lens is not None and 0 in lens:
        # a batch row with no key: autodiff of the port's plain forward
        empty = [i for i, n in enumerate(lens) if n == 0]
        rows = [i for i in rows if i not in empty]
        pq, pk, pv = (torch.from_numpy(a[empty]).requires_grad_(True)
                      for a in (q, k, v))
        plain = ref.flash_attention_fwd(
            pq.transpose(1, 2), pk.transpose(1, 2), pv.transpose(1, 2),
            tlens[empty], causal=causal, q_offset=off, window=win,
            block_kv=tile).transpose(1, 2)
        auto = torch.autograd.grad(plain, [pq, pk, pv],
                                   torch.from_numpy(ct[empty]))
        np.testing.assert_allclose(got[empty], plain.detach().numpy(),
                                   atol=ATOL)
        for label, g, w in zip(("dq", "dk", "dv"), grads, auto):
            np.testing.assert_allclose(g[empty], w.numpy(), atol=ATOL,
                                       rtol=RTOL, err_msg=f"{label} empty")
        assert np.abs(grads[0][empty]).max() == 0.0     # no score gradient
    np.testing.assert_allclose(got[rows], want_out[rows], atol=ATOL)
    for label, g, w in zip(("dq", "dk", "dv"), grads, want):
        np.testing.assert_allclose(g[rows], w[rows], atol=ATOL, rtol=RTOL,
                                   err_msg=label)


def _old_chunked_backward(q, k, v, kv_len, out, lse, do, causal, chunk,
                          q_offset, window):
    """``_ChunkedAttn.backward`` as it was before it called
    ``tiled_attention_bwd``, verbatim but for the mask helper's
    signature."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / torch.sqrt(torch.full((), float(d), dtype=torch.float32,
                                        device=q.device))
    do_f = do.float()
    do_g = do_f.reshape(b, sq, hkv, g, d)
    delta = (do_f * out.float()).sum(dim=-1).transpose(1, 2)
    delta = delta.reshape(b, hkv, g, sq)[..., None]
    qf = q.float().reshape(b, sq, hkv, g, d)
    dq = torch.zeros((b, sq, hkv, g, d), dtype=torch.float32,
                     device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for j in range(k.shape[1] // chunk):
        cols = slice(j * chunk, (j + 1) * chunk)
        kj, vj = k[:, cols], v[:, cols]
        s = tattn._gqa_scores(q, kj).float() * scale
        s = tattn._chunk_mask(sq, j * chunk, chunk, causal=causal,
                              q_offset=q_offset, window=window,
                              kv_len=kv_len, scores=s)
        pg = torch.exp(s - lse[..., None]).reshape(b, hkv, g, sq, chunk)
        dv[:, cols] = torch.einsum("bhgqc,bqhgd->bchd", pg,
                                   do_g).to(v.dtype)
        dp = torch.einsum("bqhgd,bchd->bhgqc", do_g, vj.float())
        ds = pg * (dp - delta) * scale
        dq = dq + torch.einsum("bhgqc,bchd->bqhgd", ds, kj.float())
        dk[:, cols] = torch.einsum("bhgqc,bqhgd->bchd", ds,
                                   qf).to(k.dtype)
    return dq.reshape(b, sq, hq, d).to(q.dtype), dk, dv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(True, 0, 8, 2, None), (True, 48, 4, 4,
                                                          None),
                                  (False, 0, 8, 2, [160, 99])])
def test_chunked_vjp_is_bitwise_its_old_backward(case, dtype):
    causal, window, hq, hkv, lens = case
    gen = torch.Generator().manual_seed(hq + window)
    q = torch.randn((2, 160, hq, 16), generator=gen).to(dtype)
    k, v = (torch.randn((2, 160, hkv, 16), generator=gen).to(dtype)
            for _ in range(2))
    do = torch.randn((2, 160, hq, 16), generator=gen).to(dtype)
    kv_len = None if lens is None else torch.tensor(lens)
    out, lse = tattn._chunked_forward(q, k, v, kv_len, causal, 32, 0, window)
    new = tattn.tiled_attention_bwd(q, k, v, kv_len, out, lse, do,
                                    causal=causal, chunk=32, window=window)
    old = _old_chunked_backward(q, k, v, kv_len, out, lse, do, causal, 32, 0,
                                window)
    for a, b in zip(new, old):
        assert torch.equal(a, b)
    # and through the Function, as training calls it
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    y = tattn.chunked_attention(*leaves, causal=causal, chunk=32,
                                kv_len=kv_len, window=window)
    for a, b in zip(torch.autograd.grad(y, leaves, do), old):
        assert torch.equal(a, b)


def _llama_setup():
    """Smoke llama, fp32, ``attn_impl="flash"``, one set of weights in
    both frameworks (the port's seeded init in JAX's layout)."""
    kw = dict(attn_impl="flash", dtype="float32", param_dtype="float32",
              remat=False)
    j_arch = dataclasses.replace(jax_smoke_config("llama3.2-3b"), **kw)
    t_arch = dataclasses.replace(smoke_config("llama3.2-3b"), **kw)
    params = to_jax_layout(model_lib.init_params(
        t_arch, torch.Generator().manual_seed(0), "cpu", torch.float32),
        tf.period_length(t_arch))
    return j_arch, t_arch, params


def test_flash_training_matches_jax():
    """Loss and gradients of a smoke llama at S 2 x attn_chunk through the
    flash call (the port's Function; JAX's flash impl, the chunked VJP on
    the CPU), and the same with the port's blocks recomputed."""
    j_arch, t_arch, params = _llama_setup()
    s = 2 * t_arch.attn_chunk
    tokens = np.random.default_rng(3).integers(5, t_arch.vocab_size, (2, s))
    batch = {"tokens": tokens.astype(np.int32),
             "targets": np.roll(tokens, -1, 1).astype(np.int32),
             "loss_mask": np.ones((2, s), np.float32)}
    model = build_model(j_arch)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(params, {k: jnp.asarray(v) for k, v in
                                            batch.items()})
    jgrads = jax.tree.map(np.asarray, jgrads)
    for remat in (False, True):
        arch = dataclasses.replace(t_arch, remat=remat)
        tparams = tree.map(lambda p: p.requires_grad_(True),
                           from_jax_params(arch, params, device="cpu"))
        calls = []
        real = ops._FlashAttn.forward

        def counted(*a, **kw):
            calls.append(1)
            return real(*a, **kw)
        ops._FlashAttn.forward = staticmethod(counted)
        try:
            loss, _ = model_lib.loss(arch, tparams, {
                k: torch.from_numpy(v) for k, v in batch.items()})
            grads = torch.autograd.grad(loss, tree.leaves(tparams))
        finally:
            ops._FlashAttn.forward = staticmethod(real)
        # one flash forward a layer, twice with the recompute
        assert len(calls) == arch.num_layers * (2 if remat else 1)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        _assert_trees_close(
            to_jax_layout(tree.unflatten(tparams, list(grads)),
                          tf.period_length(arch)), jgrads, "flash grad")


def test_flash_function_saves_only_its_residuals():
    """The forward keeps q, k, v, kv_len, the output and the lse (no score
    tile), and no call on the flash path refuses a gradient."""
    assert not hasattr(ops, "refuse_grad")
    saved = []
    q = torch.randn(2, 100, 4, 16, requires_grad=True)
    k = torch.randn(2, 100, 2, 16, requires_grad=True)
    v = torch.randn(2, 100, 2, 16, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        out = ops.flash_attention(q, k, v, causal=True, block_kv=32)
    assert sorted(saved) == sorted([(2, 100, 4, 16), (2, 100, 2, 16),
                                    (2, 100, 2, 16), (2,), (2, 100, 4, 16),
                                    (2, 4, 100)])
    out.sum().backward()
    assert q.grad is not None and k.grad.shape == k.shape
    with torch.no_grad():       # no gradient: the plain forward alone
        assert ops.flash_attention(q, k, v, causal=True,
                                   block_kv=32).grad_fn is None


def test_flash_lse_is_the_plain_rows_log_sum_exp():
    """``flash_attention_with_lse`` returns the plain version's output and
    each row's log-sum-exp; a row with no valid key has lse NEG_INF."""
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((2, 30, 4, 16), generator=gen)
    k, v = (torch.randn((2, 50, 2, 16), generator=gen) for _ in range(2))
    lens = torch.tensor([0, 33], dtype=torch.int32)
    out, lse = ops.flash_attention_with_lse(q, k, v, causal=False,
                                            kv_len=lens, block_kv=16)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(2, 30, 2, 2, 16),
                     k).reshape(2, 4, 30, 50) / 4.0
    want = torch.logsumexp(s[1, :, :, :33], dim=-1)
    torch.testing.assert_close(lse[1], want, atol=1e-5, rtol=1e-6)
    assert (lse[0] == ref.NEG_INF).all()
    assert torch.equal(out, ops.flash_attention(q, k, v, causal=False,
                                                kv_len=lens, block_kv=16))


def test_jax_flash_kernel_has_no_vjp():
    """A fault of the reference: ``repro.kernels.flash_attention.ops``
    says gradients flow through the chunked custom VJP, but nothing wires
    it, and ``jax.grad`` reaches ``pallas_call``'s JVP rule, which fails
    (jax 0.9.0: an AssertionError). So on a TPU, training with
    ``attn_impl="flash"`` fails in the reference. Matched loosely: a JAX
    that differentiates the kernel fails this pin, which then must go."""
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.normal(size=(1, 256, 2, 64)), jnp.float32)
               for _ in range(3))

    def f(q_):
        return jflash_ops.flash_attention(q_, k, v, causal=True,
                                          block_kv=128, interpret=True).sum()
    with pytest.raises(Exception):
        jax.grad(f)(q)
