"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the same seeded fp32 weights and
inputs: ``capacity_per_row`` over a grid, the routing indices, and
``apply_moe`` within 1e-5 with no drops, with binding capacity and with
shared experts; JAX's ``eff_capacity`` contract mirrored bitwise within
the port; the closed-form counts (``param_count``, ``active_only`` too, and
``analytical.transformer_gemms``) equal to ``repro``'s under ``==``; the
fused head's plain version with an untied head. On a card only: the
untied ``head_tokens`` kernel bitwise against its plain version on inputs
whose GEMM is exact in any order, and one MoE layer bitwise repeatable.

The card's machine has no JAX: there the ``gpu`` tests run alone, with
``python -m pytest --noconftest -m gpu tests/test_torch_moe.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.configs import smoke_config as jax_smoke_config
    from repro.core import analytical as janalytical
    from repro.models import moe as jmoe
except ImportError:         # the card's machine: only the gpu tests run
    jax = jnp = jax_get_config = jax_smoke_config = janalytical = None
    jmoe = None
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import analytical
from repro_torch.kernels.fused_lm_head import ops as head_ops
from repro_torch.kernels.fused_lm_head import ref as head_ref
from repro_torch.models import moe
from repro_torch.models.layers import unembed

torch.set_num_threads(2)

ATOL = 1e-5
ARCHS = ("deepseek-moe-16b", "jamba-v0.1-52b", "internlm2-1.8b")


def _arches(cf=1.25, shared=None, experts=None, top_k=None):
    """(JAX, port) fp32 deepseek-smoke configs with the MoE fields
    replaced."""
    out = []
    for get in (jax_smoke_config, smoke_config):
        a = get("deepseek-moe-16b")
        kw = {"capacity_factor": cf}
        if shared is not None:
            kw["num_shared_experts"] = shared
        if experts is not None:
            kw["num_experts"] = experts
        if top_k is not None:
            kw["top_k"] = top_k
        out.append(dataclasses.replace(a, dtype="float32",
                                       moe=dataclasses.replace(a.moe, **kw)))
    return out


def _weights(jarch, seed=0):
    p = jmoe.init_moe(jax.random.key(seed), jarch, jnp.float32)
    return p, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("top_k,experts", [(1, 4), (2, 4), (6, 64),
                                           (2, 16)])
@pytest.mark.parametrize("cf", [0.25, 0.6, 1.0, 1.25, 8.0])
def test_capacity_per_row_matches_jax(cf, top_k, experts):
    jarch, arch = _arches(cf, experts=experts, top_k=top_k)
    for seq in (1, 2, 7, 8, 10, 16, 64, 137, 512, 4096):
        assert moe.capacity_per_row(seq, arch.moe) == \
            jmoe.capacity_per_row(seq, jarch.moe), seq


@pytest.mark.parametrize("capacity,eff", [(5, None), (2, None), (8, 3),
                                          (3, 8)])
def test_route_indices_match_jax(capacity, eff):
    """Seeded fp32 logits of one row: the source tokens, capacity slots and
    kept flags equal JAX's, the weights within an fp32 rounding."""
    jarch, arch = _arches()
    logits = _x((16, 4), seed=2) * 3
    want = jmoe._route_indices(jnp.asarray(logits), jarch.moe, capacity,
                               None if eff is None else jnp.int32(eff))
    got = moe._route_indices(torch.from_numpy(logits), arch.moe, capacity,
                             eff)
    for name, w, g in zip(("st", "sw", "slot", "valid"), want, got):
        if name == "sw":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)


@pytest.mark.parametrize("case", ["no drops", "binding capacity",
                                  "shared experts"])
def test_apply_moe_matches_jax(case):
    cf, shared = {"no drops": (8.0, 0), "binding capacity": (0.6, 0),
                  "shared experts": (1.25, 2)}[case]
    jarch, arch = _arches(cf, shared=shared)
    jp, p = _weights(jarch)
    x = _x((3, 16, arch.d_model))
    want, jaux = jmoe.apply_moe(jarch, jp, jnp.asarray(x))
    got, aux = moe.apply_moe(arch, p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    none, no_aux = moe.apply_moe(arch, p, torch.from_numpy(x),
                                 aux_loss=False)
    assert no_aux is None and torch.equal(none, got)
    if case == "binding capacity":      # drops really happen here
        full, _ = moe.apply_moe(dataclasses.replace(
            arch, moe=dataclasses.replace(arch.moe, capacity_factor=8.0)),
            p, torch.from_numpy(x))
        assert not torch.allclose(full, got, atol=ATOL)


def test_eff_capacity_reproduces_unpadded_dispatch():
    """JAX's chunked-prefill contract (``tests/test_moe.py``), bitwise
    within the port: a prompt of 10 tokens padded to 16 drops, at its own
    capacity, exactly what the unpadded 10-token dispatch drops; without
    ``eff_capacity`` the padded shape keeps more; ``eff_capacity`` at the
    shape's own bucket changes nothing."""
    jarch, arch = _arches(0.6)
    _, p = _weights(jarch)
    n_valid, s = 10, 16
    x_pad = torch.from_numpy(_x((1, s, arch.d_model)))
    x_real = x_pad[:, :n_valid]
    cap_real = moe.capacity_per_row(n_valid, arch.moe)
    y_pad, _ = moe.apply_moe(arch, p, x_pad, eff_capacity=cap_real)
    y_real, _ = moe.apply_moe(arch, p, x_real)
    assert torch.equal(y_pad[:, :n_valid], y_real)
    u_pad, _ = moe.apply_moe(arch, p, x_pad)
    assert not torch.equal(u_pad[:, :n_valid], y_real)
    y_same, _ = moe.apply_moe(arch, p, x_pad,
                              eff_capacity=moe.capacity_per_row(s, arch.moe))
    assert torch.equal(y_same, u_pad)


def test_decode_rows_route_alone_and_drop_nothing():
    """A decode step's [slots, 1, D]: every row is its own routing row with
    one capacity slot an expert, so a row's routing does not depend on the
    other rows (its output only through the GEMMs' shapes), and nothing
    drops: the output equals the no-drop mixture."""
    jarch, arch = _arches(1.25)
    _, p = _weights(jarch)
    x = torch.from_numpy(_x((5, 1, arch.d_model)))
    y, _ = moe.apply_moe(arch, p, x)
    logits = x.float() @ p["router"]
    routed = moe._route(logits, arch.moe, 1)
    assert bool(routed["valid"].all())
    for i in range(5):
        alone = moe._route(logits[i:i + 1], arch.moe, 1)
        for k in ("st", "slot", "valid"):
            assert torch.equal(alone[k], routed[k][i:i + 1])
        torch.testing.assert_close(moe.apply_moe(arch, p, x[i:i + 1])[0],
                                   y[i:i + 1], atol=ATOL, rtol=0)
    full, _ = moe.apply_moe(dataclasses.replace(
        arch, moe=dataclasses.replace(arch.moe, capacity_factor=8.0)), p, x)
    torch.testing.assert_close(y, full, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_counts_match_jax(name, smoke):
    """``param_count`` (all and active) and the forward, backward-activation
    and backward-weight GEMM inventories equal ``repro``'s under ``==``."""
    jarch = (jax_smoke_config if smoke else jax_get_config)(name)
    arch = (smoke_config if smoke else get_config)(name)
    for active in (False, True):
        assert arch.param_count(active) == jarch.param_count(active)
    assert [arch.is_moe_layer(i) for i in range(arch.num_layers)] == \
        [jarch.is_moe_layer(i) for i in range(jarch.num_layers)]
    for phase in ("fwd", "bwd_act", "bwd_w"):
        got = analytical.transformer_gemms(arch, 2, 64, phase)
        want = janalytical.transformer_gemms(jarch, 2, 64, phase)
        assert [dataclasses.astuple(g) for g in got] == \
            [dataclasses.astuple(g) for g in want]
    got = analytical.nongemm_ops(arch, 2, 64)
    want = janalytical.nongemm_ops(jarch, 2, 64)
    assert [dataclasses.astuple(o) for o in got] == \
        [dataclasses.astuple(o) for o in want]


def test_full_width_counts():
    """deepseek-moe-16b's 16,879,566,848 parameters (2.83 B active): 33.8
    GB in bf16 on one H100."""
    arch = get_config("deepseek-moe-16b")
    assert arch.param_count() == 16_879_566_848
    assert 2.8e9 < arch.param_count(active_only=True) < 2.9e9


@pytest.mark.parametrize("sampled,filtered", [(False, False), (True, False),
                                              (True, True)])
def test_untied_head_plain_version(sampled, filtered):
    """``ref.head_tokens`` with an untied head [D, V] is ``head_epilogue``
    of ``unembed``'s ``p["head"]`` logits, and the wrapper takes the same
    path for CPU tensors."""
    g = torch.Generator().manual_seed(3)
    s, d, v = 5, 64, 384
    x = torch.randn((s, d), generator=g)
    head = torch.randn((d, v), generator=g)
    seeds = torch.arange(s, dtype=torch.int64) * 7919
    pos = torch.arange(s, dtype=torch.int32) + 11
    temps = torch.tensor([0.0, 0.8, 1.0, 0.5, 1.3])
    top_k = torch.tensor([0, 20, 0, 5, 40], dtype=torch.int32)
    top_p = torch.tensor([1.0, 0.9, 0.95, 1.0, 0.8])
    rs = head_ref.row_uniforms(seeds, pos)
    flags = dict(sampled=sampled, filtered=filtered)
    want = head_ref.head_epilogue(unembed({"head": head}, x, None), rs,
                                  temps, top_k, top_p, **flags)
    got = head_ref.head_tokens(x, head, rs, temps, top_k, top_p,
                               untied=True, **flags)
    ops = head_ops.head_tokens(x, head, seeds, pos, temps, top_k, top_p,
                               untied=True, **flags)
    for out in (got, ops):
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


# ------------------------------------------------------------- on a card ----

def _exact_inputs(s, d, v, gen):
    """x and an untied head whose every product and partial sum is exact in
    fp32 (small integers times powers of two), so any summation order gives
    the same logits."""
    x = torch.randint(-3, 4, (s, d), generator=gen, device="cuda")
    w = torch.randint(-3, 4, (d, v), generator=gen, device="cuda")
    return (x * 0.125).bfloat16(), (w * 0.0625).bfloat16()


@pytest.mark.gpu
@pytest.mark.parametrize("d,v", [(2048, 102400), (2048, 92544),
                                 (4096, 65536), (128, 512)])
@pytest.mark.parametrize("s", [1, 8, 16])
@pytest.mark.parametrize("sampled,filtered", [(False, False), (True, True)])
def test_untied_head_kernel_matches_plain_on_card(s, d, v, sampled, filtered):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    gen = torch.Generator(device="cuda").manual_seed(s + d + v)
    x, w = _exact_inputs(s, d, v, gen)
    seeds = torch.arange(s, dtype=torch.int64, device="cuda") * 104729
    pos = torch.arange(s, dtype=torch.int32, device="cuda") + 100
    temps = torch.full((s,), 0.8, device="cuda")
    temps[0] = 0.0
    top_k = torch.full((s,), 40, dtype=torch.int32, device="cuda")
    top_p = torch.full((s,), 0.95, device="cuda")
    flags = dict(sampled=sampled, filtered=filtered)
    before = head_ops.LAUNCHES["head_tokens"]
    tok, ok = head_ops.head_tokens(x, w, seeds, pos, temps, top_k, top_p,
                                   untied=True, **flags)
    assert head_ops.LAUNCHES["head_tokens"] == before + 1
    want = head_ref.head_tokens(x, w, head_ref.row_uniforms(seeds, pos),
                                temps, top_k, top_p, untied=True, **flags)
    assert torch.equal(tok, want[0]) and torch.equal(ok, want[1])
    with pytest.raises(ValueError, match="untied head"):
        head_ops.head_tokens(x, w.T.contiguous(), seeds, pos, temps, top_k,
                             top_p, untied=True, **flags)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s", [(8, 1), (1, 64)])
def test_moe_layer_is_bitwise_repeatable_on_card(b, s):
    """One deepseek-width MoE layer (64 experts of 1408, top-6, 2 shared;
    bf16) called twice on the same input gives the same bits: the dispatch
    and combine are gathers, no float atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    arch = get_config("deepseek-moe-16b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = moe.init_moe(gen, arch, "cuda", torch.bfloat16)
    x = torch.randn((b, s, arch.d_model), generator=gen,
                    device="cuda").bfloat16()
    y1, _ = moe.apply_moe(arch, p, x, aux_loss=False)
    y2, _ = moe.apply_moe(arch, p, x, aux_loss=False)
    assert torch.isfinite(y1).all() and torch.equal(y1, y2)
