"""The weight bridge (JAX ``Model.init`` pytree -> the port's weights) and
the port's full-sequence logits against ``Model.forward`` on the smoke
model, fp32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro_torch.configs import smoke_config
from repro_torch.models import transformer as tf
from repro_torch.models.convert import from_jax_params
from repro_torch.models.layers import pad_vocab
from repro_torch.models.model import Model

torch.set_num_threads(2)


def _archs(dtype="float32"):
    j = dataclasses.replace(jax_smoke_config("llama3.2-3b"), dtype=dtype,
                            param_dtype="float32")
    t = dataclasses.replace(smoke_config("llama3.2-3b"), dtype=dtype)
    return j, t


@pytest.mark.parametrize("scan_layers,tied", [(True, True), (False, True),
                                              (True, False)])
def test_converted_shapes_and_dtypes(scan_layers, tied):
    j_arch, t_arch = _archs("bfloat16")
    j_arch = dataclasses.replace(j_arch, scan_layers=scan_layers,
                                 tie_embeddings=tied)
    t_arch = dataclasses.replace(t_arch, tie_embeddings=tied)
    params = build_model(j_arch).init(jax.random.key(1))
    p = from_jax_params(t_arch, jax.tree.map(np.asarray, params),
                        device="cpu")
    d, vp = t_arch.d_model, pad_vocab(t_arch.vocab_size)
    assert p["embed"]["embedding"].shape == (vp, d)
    assert p["final_norm"]["scale"].shape == (d,)
    assert ("out" in p) == (not tied)
    if not tied:
        assert p["out"]["head"].shape == (d, vp)
    assert len(p["blocks"]) == t_arch.num_layers
    want = {("ln1", "scale"): (d,), ("ln2", "scale"): (d,),
            ("attn", "wqkv"): (d, t_arch.q_dim + 2 * t_arch.kv_dim),
            ("attn", "wo"): (t_arch.q_dim, d),
            ("mlp", "w1"): (d, t_arch.d_ff), ("mlp", "w3"): (d, t_arch.d_ff),
            ("mlp", "w2"): (t_arch.d_ff, d)}
    for i, blk in enumerate(p["blocks"]):
        got = {(a, b): tuple(t.shape) for a, sub in blk.items()
               for b, t in sub.items()}
        assert got == want, i
        for sub in blk.values():
            for t in sub.values():
                assert t.dtype == torch.bfloat16 and t.device.type == "cpu"
    # values carried over exactly (layer 1's fused qkv, from either layout)
    blocks = params["blocks"]
    w = blocks["layer_0"]["attn"]["wqkv"][1] if scan_layers else \
        blocks["period_1"]["layer_0"]["attn"]["wqkv"]
    np.testing.assert_array_equal(
        p["blocks"][1]["attn"]["wqkv"].float().numpy(),
        torch.from_numpy(np.array(w)).to(torch.bfloat16).float().numpy())


def test_full_logits_match_model_forward():
    """Prefill the whole prompt as one paged chunk and read the logits of
    every position: equal to the JAX full-sequence forward within 1e-4
    (fp32; two layers of reassociated sums over widths <= 512)."""
    j_arch, t_arch = _archs()
    model = build_model(j_arch)
    params = model.init(jax.random.key(0))
    t_model = Model(t_arch, from_jax_params(
        t_arch, jax.tree.map(np.asarray, params), device="cpu"))
    rng = np.random.default_rng(0)
    n, page, chunk = 21, 8, 24
    tokens = rng.integers(5, t_arch.vocab_size, (1, n))
    ref, _ = model.forward(params, {"tokens": jnp.asarray(tokens)})
    pools = tf.init_serving_state(t_arch, 5, page, 1, torch.float32, "cpu")
    padded = np.zeros((1, chunk), np.int64)
    padded[0, :n] = tokens[0]
    with torch.inference_mode():
        x = tf.paged_prefill_stack(
            t_arch, t_model.params["blocks"], pools,
            t_model._embed(torch.from_numpy(padded)),
            torch.tensor([1, 2, 3, 4], dtype=torch.int32), 0, n)
        logits = t_model._logits(x)[:, :n]
    assert logits.shape == ref.shape
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_init_distributions_are_seeded():
    _, t_arch = _archs()
    m = Model.init(t_arch, torch.Generator().manual_seed(0), device="cpu")
    w = m.params["blocks"][0]["mlp"]["w1"]
    assert w.dtype == torch.float32
    scaled = w * (t_arch.d_model ** 0.5)
    assert scaled.abs().max() <= 2.0 + 1e-5           # truncated at 2 sigma
    assert 0.7 < float(scaled.std()) < 1.0            # N(0,1) cut at +-2: 0.88
    emb = m.params["embed"]["embedding"]
    assert abs(float(emb.std()) - 0.02) < 2e-3
    m2 = Model.init(t_arch, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(w, m2.params["blocks"][0]["mlp"]["w1"])
