"""The pieces of the mamba mixer's model-axis split, in one process:

- a rank's columns of the fused ``in_proj`` [z | x | B | C | dt] and of
  ``conv`` [x | B | C] (``parallel.sharding.train_block_index``): every
  rank's blocks put back together give the leaf, each block is 1 / tp of
  it, and a rank's z, x and dt columns are those of its H / tp heads, at
  the smoke configs on the CPU and at full width for mamba2-1.3b and
  jamba-v0.1-52b (8512 / 4352 and 16544 / 8224 columns);
- row 11's split plain path (``ref.gated_rmsnorm_partial``, the row sums
  of 2 and 4 column shards added as the model axis's ``psum`` adds them,
  then ``ref.gated_rmsnorm_apply`` on each shard) against the whole-row
  plain version and JAX's ``ref.gated_rmsnorm``, forward and gradients
  (y, z and scale), in fp32 within 1e-5 relative / 1e-6 absolute; the
  wrapper's split pieces on CPU tensors are the plain ones and count no
  launch;
- the split norm's backward (``ref.gated_rmsnorm_split_grads``, each
  shard in a thread of its own, the row sums added across them as the
  model axis's all-reduce adds them): against JAX's VJP in fp32, and in
  bf16 against autograd of the whole-row plain version, bitwise for a
  whole row in one piece and over 2 and 4 shards within 1 bf16 ulp of the
  row's largest |gradient|, at most one element in 1000 apart (it runs
  the whole row's backward ops in their order).

``tests/test_torch_gated_split_gpu.py`` holds the two CUDA entries to
their plain versions on a card.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_layernorm import ref as jln_ref
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.fused_layernorm import ops as ln_ops
from repro_torch.kernels.fused_layernorm import ref as ln_ref
from repro_torch.models import ssm
from repro_torch.parallel import sharding

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
ARCHS = [("smoke", "mamba2-1.3b", 2), ("smoke", "mamba2-1.3b", 4),
         ("smoke", "jamba-v0.1-52b", 2), ("full", "mamba2-1.3b", 2),
         ("full", "jamba-v0.1-52b", 2), ("full", "mamba2-1.3b", 4)]


def _arch(kind, name):
    return (smoke_config if kind == "smoke" else get_config)(name)


@pytest.mark.parametrize("kind,name,tp", ARCHS)
@pytest.mark.parametrize("leaf", ["in_proj", "conv"])
def test_rank_blocks_reassemble_the_fused_leaf(kind, name, tp, leaf):
    arch = _arch(kind, name)
    widths = sharding.mamba_segments(arch, leaf)
    n = sum(widths)
    whole = torch.arange(3 * n).reshape(3, n)   # 3 rows stand for D or W
    sp = (None, "model")
    got = torch.full_like(whole, -1)
    for r in range(tp):
        idx = sharding.train_block_index(
            ("blocks", "0", "mamba", leaf), whole.shape, sp, arch,
            {"model": tp}, {"model": r})
        block = whole[idx]
        assert block.shape == (3, n // tp)
        got[idx] = block
    assert torch.equal(got, whole)
    if (kind, name) == ("full", "mamba2-1.3b"):
        assert (n, tp) in ((8512, 2), (4352, 2), (8512, 4), (4352, 4))
    if (kind, name) == ("full", "jamba-v0.1-52b"):
        assert n in (16544, 8224)


@pytest.mark.parametrize("kind,name,tp", ARCHS)
def test_rank_z_x_dt_columns_are_its_heads(kind, name, tp):
    arch = _arch(kind, name)
    inner, h = ssm.inner_dim(arch), ssm.num_ssm_heads(arch)
    p, gn = arch.ssm.head_dim, arch.ssm.ngroups * arch.ssm.state_dim
    n = 2 * inner + 2 * gn + h
    for r in range(tp):
        cols = sharding.train_block_index(
            ("blocks", "3", "mamba", "in_proj"), (4, n), (None, "model"),
            arch, {"model": tp}, {"model": r})[1]
        hl, il, gl = h // tp, inner // tp, gn // tp
        heads = torch.arange(r * hl, (r + 1) * hl)
        channels = (heads[:, None] * p + torch.arange(p)[None]).reshape(-1)
        z, x, b, c, dt = torch.split(cols, [il, il, gl, gl, hl])
        assert torch.equal(z, channels)
        assert torch.equal(x, inner + channels)
        assert torch.equal(dt, 2 * inner + 2 * gn + heads)
        assert torch.equal(b, 2 * inner + torch.arange(r * gl, (r + 1) * gl))
        assert torch.equal(c, 2 * inner + gn
                           + torch.arange(r * gl, (r + 1) * gl))


def _inputs(rows, c, seed):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(2, rows, c)).astype(np.float32)
    z = (2 * rng.normal(size=(2, rows, c))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (c,)).astype(np.float32)
    return y, z, scale


def _split(y, z, scale, tp):
    """The split plain path over ``tp`` column shards; the partials' sum
    stands for the model axis's psum (whose backward sums their
    gradients: autograd of the sum gives every shard the total's)."""
    c = y.shape[-1]
    w = c // tp
    ys, zs, ss = (t.split(w, dim=-1) for t in (y, z, scale))
    sq = sum(ln_ref.gated_rmsnorm_partial(a, b) for a, b in zip(ys, zs))
    return torch.cat([ln_ref.gated_rmsnorm_apply(a, b, sq, s, c)
                      for a, b, s in zip(ys, zs, ss)], dim=-1)


@pytest.mark.parametrize("tp", [2, 4])
def test_split_plain_path_matches_whole_row_and_jax(tp):
    y, z, scale = _inputs(8, 64, tp)
    g = np.random.default_rng(7).normal(size=y.shape).astype(np.float32)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (y, z, scale)]
    out = _split(*ts, tp)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ts)
    ws = [torch.from_numpy(a).requires_grad_(True) for a in (y, z, scale)]
    whole = ln_ref.gated_rmsnorm(*ws)
    wgrads = torch.autograd.grad((whole * torch.from_numpy(g)).sum(), ws)
    np.testing.assert_allclose(out.detach().numpy(),
                               whole.detach().numpy(), rtol=RTOL, atol=ATOL)
    for a, b in zip(grads, wgrads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL)
    args = [jnp.asarray(a) for a in (y, z, scale)]
    jout, vjp = jax.vjp(jln_ref.gated_rmsnorm, *args)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    for a, b in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def test_split_wrappers_take_the_plain_pieces_on_the_cpu():
    y, z, scale = (torch.from_numpy(a) for a in _inputs(4, 32, 3))
    before = dict(ln_ops.LAUNCHES)
    sq = ln_ops.gated_rmsnorm_partial(y, z)
    assert sq.dtype == torch.float32 and sq.shape == y.shape[:-1]
    assert torch.equal(sq, ln_ref.gated_rmsnorm_partial(y, z))
    out = ln_ops.gated_rmsnorm_apply(y, z, sq, scale, c=32)
    assert torch.equal(out, ln_ref.gated_rmsnorm_apply(y, z, sq, scale, 32))
    # a whole row in one piece is the whole-row norm, to rounding
    np.testing.assert_allclose(out.numpy(), ln_ref.gated_rmsnorm(
        y, z, scale).numpy(), rtol=RTOL, atol=ATOL)
    assert dict(ln_ops.LAUNCHES) == before
    with pytest.raises(ValueError, match="unsupported device"):
        ln_ops.gated_rmsnorm_partial(y.to("meta"), z.to("meta"))


@pytest.mark.parametrize("c", [12, 1 << 20])
def test_split_entries_refuse_a_row_without_a_register_plan(c):
    # the split entries have no wide variant: a row no register plan
    # covers (not a multiple of 8 columns, or too wide) is refused
    assert ln_ops.norm_plan(8, c, True) == ln_ops.NORM_WIDE
    with pytest.raises(ValueError, match="no register plan"):
        ln_ops._split_plan(8, c, "gated_rmsnorm_partial")
    assert ln_ops._split_plan(1024, 2048, "gated_rmsnorm_apply")[1] > 0


def _split_grads(y, z, scale, g, tp):
    """(dy, dz, dscale) of the split norm over ``tp`` column shards, each
    shard's ``gated_rmsnorm_split_grads`` in a thread, its row sums
    summed over the threads (a barrier for the all-reduce)."""
    c = y.shape[-1]
    ys, zs, ss, gs = (t.split(c // tp, dim=-1) for t in (y, z, scale, g))
    sq = sum(ln_ref.gated_rmsnorm_partial(a, b) for a, b in zip(ys, zs))
    barrier, parts, out = threading.Barrier(tp), [None] * tp, [None] * tp

    def psum(r):
        def add(t):
            parts[r] = t.clone()
            barrier.wait()
            t.copy_(sum(parts))
            barrier.wait()
            return t
        return add

    def run(r):
        out[r] = ln_ref.gated_rmsnorm_split_grads(
            ys[r], zs[r], ss[r], sq, gs[r], c, psum=psum(r))
    threads = [threading.Thread(target=run, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return (torch.cat([o[0] for o in out], -1),
            torch.cat([o[1] for o in out], -1),
            torch.cat([o[2] for o in out], -1))


@pytest.mark.parametrize("tp", [2, 4])
def test_split_backward_matches_jax(tp):
    y, z, scale = _inputs(8, 64, 10 + tp)
    g = np.random.default_rng(11).normal(size=y.shape).astype(np.float32)
    got = _split_grads(*(torch.from_numpy(a) for a in (y, z, scale, g)), tp)
    _, vjp = jax.vjp(jln_ref.gated_rmsnorm,
                     *(jnp.asarray(a) for a in (y, z, scale)))
    for a, b in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_split_backward_rounds_as_the_whole_row_in_bf16(tp):
    gen = torch.Generator().manual_seed(tp)
    y = torch.randn((64, 512), generator=gen).bfloat16()
    z = (2 * torch.randn((64, 512), generator=gen)).bfloat16()
    scale = (1 + 0.1 * torch.randn((512,), generator=gen)).bfloat16()
    g = torch.randn((64, 512), generator=gen).bfloat16()
    ts = [t.clone().requires_grad_(True) for t in (y, z, scale)]
    want = torch.autograd.grad(ln_ref.gated_rmsnorm(*ts), ts, g)
    got = _split_grads(y, z, scale, g, tp)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.bfloat16
        if tp == 1:
            assert torch.equal(a, b)
        big = b.float().abs().amax(dim=-1, keepdim=True)
        ulp = torch.exp2(torch.floor(torch.log2(big.clamp_min(2.0 ** -126)))
                         - 7)
        gap = (a.float() - b.float()).abs()
        assert bool((gap <= ulp).all())
        assert int((gap > 0).sum()) <= a.numel() // 1000
