"""The port's primitive layers against ``repro.models.layers`` on the same
numpy inputs, fp32, atol 1e-5 (reassociation of fp32 sums only)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.configs import smoke_config
from repro_torch.models import layers as tl

torch.set_num_threads(2)

ATOL = 1e-5


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=atol,
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 128)).astype(np.float32) * 2.0
    p = {"scale": rng.normal(size=(128,)).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.normal(size=(128,)).astype(np.float32)
    ref = jl._apply_norm(kind, {k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    out = tl.apply_norm(kind, {k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x))
    _close(ref, out)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_matches(theta):
    """Against ``apply_rope`` under jit, as every JAX engine and step runs
    it: XLA then evaluates ``1 / theta ** e`` as ``theta ** -e``, an ulp
    away from the op-by-op result in some frequencies, and the port follows
    the jitted form (``tl.rope_frequencies``)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(2, 7))
    ref = jax.jit(jl.apply_rope, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(pos), theta)
    out = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(ref, out, atol=ATOL)


def test_swiglu_matches():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 128)).astype(np.float32)
    p = {"w1": rng.normal(size=(128, 256)).astype(np.float32) / 11,
         "w3": rng.normal(size=(128, 256)).astype(np.float32) / 11,
         "w2": rng.normal(size=(256, 128)).astype(np.float32) / 16}
    ref = jl._apply_mlp("swiglu", {k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    out = tl.apply_mlp("swiglu", {k: torch.from_numpy(v)
                                  for k, v in p.items()}, torch.from_numpy(x))
    _close(ref, out)
    _close(jl.silu(jnp.asarray(x)), tl.silu(torch.from_numpy(x)))


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_embed_unembed_match(softcap):
    arch = smoke_config("llama3.2-3b")
    rng = np.random.default_rng(3)
    vp = tl.pad_vocab(arch.vocab_size)
    assert vp == jl.pad_vocab(arch.vocab_size)
    emb = (rng.normal(size=(vp, arch.d_model)) * 0.02).astype(np.float32)
    head = rng.normal(size=(arch.d_model, vp)).astype(np.float32) / 11
    tok = rng.integers(0, arch.vocab_size, size=(2, 6))
    x_ref = jl.embed_tokens({"embedding": jnp.asarray(emb)}, jnp.asarray(tok),
                            jnp.float32)
    x = tl.embed_tokens({"embedding": torch.from_numpy(emb)},
                        torch.from_numpy(tok), torch.float32)
    _close(x_ref, x)
    h = rng.normal(size=(2, 6, arch.d_model)).astype(np.float32)
    for tied in (True, False):
        ref = jl.unembed({"head": jnp.asarray(head)}, jnp.asarray(h),
                         jnp.asarray(emb) if tied else None, softcap)
        out = tl.unembed({"head": torch.from_numpy(head)}, torch.from_numpy(h),
                         torch.from_numpy(emb) if tied else None, softcap)
        assert out.dtype == torch.float32
        _close(ref, out)


def test_dense_and_dtype_map():
    from repro_torch.configs import torch_dtype
    assert torch_dtype("bfloat16") is torch.bfloat16
    assert torch_dtype("float32") is torch.float32
    with pytest.raises(ValueError):
        torch_dtype("int3")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 16)).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    _close(jl.dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
           tl.dense(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b)))


def test_smoke_config_matches_jax_reductions():
    from repro.configs import smoke_config as jax_smoke
    j, t = jax_smoke("llama3.2-3b"), smoke_config("llama3.2-3b")
    for f in dataclasses.fields(t):     # the port keeps a subset of fields
        assert getattr(t, f.name) == getattr(j, f.name), f.name
