"""The port's operator-level characterization (``repro_torch.core.optrace``
and ``characterize``) against the JAX package's (``repro.core.hlotext`` and
``characterize``), on the CPU at smoke size:

- a [64, 128] @ [128, 256] product prices to exactly 2 * 64 * 128 * 256
  FLOPs on both sides; a 24-step Python loop of ``tanh(c @ w)`` lands
  within 5% of JAX's scanned loop (JAX multiplies the while body by its
  trip count; the port records every step);
- ``tensor_bytes`` is ``shape_bytes``, the ring wire model JAX's, and
  ``bucket_scopes`` JAX's, on the same inputs;
- the unfused fp32 bert-large-smoke training step (B2 / S32, LAMB, weights
  converted from JAX's init with perturbed biases, as
  ``tests/test_torch_training.py``): GEMM FLOPs within 2% of JAX's
  ``analyze_text`` of the compiled step (no fused epilogue closes a gap
  here: the XLA CPU compile puts no elementwise op into a dot's fusion,
  and both come out equal), the same buckets with FLOPs, GEMM FLOPs by
  bucket equal to the analytical model's Table 3 rows (plus the
  recomputed block forwards and the MLM transform's dense, which Table 3
  leaves out), backward and recomputed GEMMs in their forward's bucket;
- the fused step: one op a kernel call, by name and count
  ``chip_smoke.expected_train_launches``; every hand-written kernel's
  stated FLOP count equal to its plain version's priced ops;
- a traced step's losses and state bitwise an untraced step's; a scope
  with no recorder active enters no profiler range; the profile
  attribution (``optrace.device_times``) on a synthetic event list.
"""
import dataclasses
import importlib.util
import itertools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import ShapeConfig as JaxShapeConfig
from repro.configs import smoke_config as jax_smoke_config
from repro.core import characterize as jchar
from repro.core import hlotext
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticPipeline as JaxPipeline
from repro.models import build_model
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train.steps import build_train_step as jax_build_train_step
from repro_torch import tree
from repro_torch.configs import RunConfig, ShapeConfig, smoke_config
from repro_torch.core import analytical, characterize, optrace
from repro_torch.models.convert import from_jax_params
from repro_torch.train.steps import build_train_step

torch.set_num_threads(2)

B, S = 2, 32
BIASES = ("bias", "bqkv", "bo", "b1", "b2")
REPO = Path(__file__).resolve().parents[1]


def _jax_cost(fn, *args):
    text = jax.jit(fn).lower(*args).compile().as_text()
    return jchar.analyze_text(text, 1)


# ------------------------------------------------------------ unit rules --

def test_dot_flops_exact():
    a, b = np.zeros((64, 128), np.float32), np.zeros((128, 256), np.float32)
    want = 2 * 64 * 128 * 256
    cost = characterize.analyze(lambda x, y: x @ y, torch.from_numpy(a),
                                torch.from_numpy(b))
    assert cost.flops == want == cost.by_category["gemm"]
    assert _jax_cost(lambda x, y: x @ y, a, b).flops == want


def test_python_loop_matches_jax_scan():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 64)).astype(np.float32)
    ws = rng.normal(size=(24, 64, 64)).astype(np.float32)

    def scanned(x, ws):
        return jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)[0]

    def loop(x, ws):
        for i in range(24):
            x = torch.tanh(x @ ws[i])
        return x

    want = _jax_cost(scanned, x, ws).flops
    got = characterize.analyze(loop, torch.from_numpy(x),
                               torch.from_numpy(ws)).flops
    assert abs(got - want) / want < 0.05, (got, want)


@pytest.mark.parametrize("dtype", sorted(optrace.HLO_TYPES, key=str),
                         ids=str)
def test_tensor_bytes_is_shape_bytes(dtype):
    name = optrace.HLO_TYPES[dtype]
    for shape in ((8, 4), (10,), (), (2, 3, 5), (0, 7)):
        text = f"{name}[{','.join(map(str, shape))}]{{0}}"
        assert optrace.tensor_bytes(shape, dtype) == \
            hlotext.shape_bytes(text), (dtype, shape)
        assert optrace.tensor_bytes(shape, name) == hlotext.shape_bytes(text)
    assert optrace.tensor_bytes((3,), "token") == hlotext.shape_bytes(
        "token[3]") == 0


def test_wire_model_is_jaxs():
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "ragged-all-to-all", "collective-broadcast",
             "collective-permute")
    port_ops, jax_ops = [], []
    for i, (kind, g, pod) in enumerate(itertools.product(
            kinds, (1, 2, 4, 16, 512), (False, True))):
        fields = dict(kind=kind, result_bytes=1000 * (i + 1),
                      operand_bytes=700 * (i + 2), group_size=g,
                      crosses_pod=pod, name=f"c{i}")
        port_ops.append(optrace.CollectiveOp(**fields))
        jax_ops.append(hlotext.CollectiveOp(**fields))
        assert port_ops[-1].wire_bytes == jax_ops[-1].wire_bytes, fields
    got = optrace.CollectiveSummary(port_ops)
    want = hlotext.CollectiveSummary(jax_ops)
    assert got.to_dict() == want.to_dict()
    rec = got.collectives()
    assert (rec.operand_bytes, rec.wire_bytes_ici, rec.wire_bytes_dcn) == \
        (want.operand_bytes, want.wire_bytes_ici, want.wire_bytes_dcn)


def test_bucket_scopes_is_jaxs():
    scopes = {
        "jit(step)/lamb/mul": 10.0,
        "jit(step)/while/body/mlp/dot_general": 5.0,
        "jit(step)/while/attn_core/exp": 2.0,
        "unknown_thing": 1.0, "unscoped": 0.5, "": 0.25,
        "attn_qkv": 3.0, "attn_out": 4.0, "attn_core": 6.0,
        "mlp/bias_gelu": 7.0, "norm": 8.0, "logits/norm": 9.0,
        "fused_residual_layernorm": 11.0, "embed": 12.0, "logits": 13.0,
        "loss": 14.0, "lamb/lamb_stage1": 15.0, "adamw": 16.0,
        "moe/norm": 17.0, "mamba/gated_rmsnorm": 18.0, "head_tokens": 19.0,
        "decode_residual_norm": 20.0, "attn_core/flash_attention": 21.0,
    }
    assert characterize.bucket_scopes(scopes) == jchar.bucket_scopes(scopes)
    for s, _ in jchar._SCOPE_BUCKETS:
        assert any(b == s for b, _ in characterize._SCOPE_BUCKETS)
    assert [(b, p.pattern, p.flags) for b, p in characterize._SCOPE_BUCKETS] \
        == [(b, p.pattern, p.flags) for b, p in jchar._SCOPE_BUCKETS]


@pytest.mark.parametrize("name,want", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "BinaryFunctor<float, float, float, at::native::binary_internal::"
     "MulFunctor<float> >, std::array<char*, 3ul> >(int, ...)",
     "elementwise"),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::"
     "operator()() const::{lambda(float)#1}, ...>", "data_movement"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul> >(int, ...)",
     "data_movement"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::NormTwoOps<float, float, float>, unsigned int, float, 4, "
     "4> >(...)", "reduction"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>",
     "data_movement"),
    ("void at::native::index_elementwise_kernel<128, 4, ...>",
     "data_movement"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, "
     "float, float, float, ...>", "fusion"),
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_TNT", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "gemm"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>",
     "sort"),
    ("Memcpy HtoD (Pinned -> Device)", "data_movement"),
    ("some_hand_written_kernel", "other")])
def test_kernel_category_from_a_kernel_name(name, want):
    assert optrace.kernel_category(name) == want


# ------------------------------------------------------ the bert step ------

def _archs():
    j = dataclasses.replace(jax_smoke_config("bert-large"), dtype="float32",
                            param_dtype="float32")
    t = dataclasses.replace(smoke_config("bert-large"), dtype="float32",
                            param_dtype="float32")
    return j, t


@pytest.fixture(scope="module")
def setup():
    """JAX's characterization of its compiled unfused step, the weights it
    ran on (numpy, biases perturbed) and the step's batch."""
    j_arch, t_arch = _archs()
    model = build_model(j_arch)
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0)))
    rng = np.random.default_rng(0)

    def perturb(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name in BIASES:
            return (leaf + 0.1 * rng.normal(size=leaf.shape)
                    ).astype(np.float32)
        return leaf
    params = jax.tree_util.tree_map_with_path(perturb, params)
    batch = JaxPipeline(JaxDataConfig(
        vocab_size=j_arch.vocab_size, seq_len=S, global_batch=B,
        objective="mlm", seed=0)).batch(0)
    run = JaxRunConfig(arch=j_arch, shape=JaxShapeConfig(
        "t", seq_len=S, global_batch=B, kind="train"), learning_rate=1e-3,
        zero1=False)
    p = jax.tree.map(jnp.asarray, params)
    state = {"opt": jax_make_optimizer(run).init(p), "params": p}
    text = jax.jit(jax_build_train_step(run).fn).lower(
        state, {k: jnp.asarray(v) for k, v in batch.items()}
    ).compile().as_text()
    return {"t_arch": t_arch, "params": params, "batch": batch,
            "jax": jchar.analyze_text(text, 1)}


def _bundle(t_arch, fused: bool, monkeypatch):
    monkeypatch.setenv("REPRO_FUSED_BLOCKS", "1" if fused else "0")
    return build_train_step(RunConfig(
        arch=t_arch, shape=ShapeConfig("t", seq_len=S, global_batch=B,
                                       kind="train"),
        learning_rate=1e-3, zero1=False, fused_optimizer_kernel=fused),
        device="cpu")


def _traced(setup, fused, monkeypatch):
    bundle = _bundle(setup["t_arch"], fused, monkeypatch)
    state = bundle.init(params=from_jax_params(setup["t_arch"],
                                               setup["params"], device="cpu"))
    return characterize.analyze(bundle.eager, state, setup["batch"]), state


@pytest.fixture(scope="module")
def unfused(setup):
    mp = pytest.MonkeyPatch()
    try:
        return _traced(setup, False, mp)[0]
    finally:
        mp.undo()


def _gemm_by(cost, key):
    out = {}
    for op in cost.ops:
        if op.category == "gemm":
            k = key(op)
            out[k] = out.get(k, 0.0) + characterize.price(op)[0]
    return out


def test_step_gemm_flops_match_jax(setup, unfused):
    got, want = unfused.by_category["gemm"], setup["jax"].by_category["gemm"]
    assert abs(got - want) / want < 0.02, (got, want)


def test_step_buckets_with_flops_match_jax(setup, unfused):
    def nonzero(cost):
        return {k for k, v in jchar.bucket_scopes(cost.by_scope).items()
                if v > 0}
    got = {k for k, v in characterize.bucket_scopes(unfused.by_scope).items()
           if v > 0}
    assert got == nonzero(setup["jax"]), (got, nonzero(setup["jax"]))


def test_step_gemm_by_bucket_is_the_analytical_inventory(setup, unfused):
    arch = setup["t_arch"]
    bucket = {"attn_linear": "attn_linear", "attn_bgemm": "attn_bgemm",
              "fc": "mlp", "head": "embed_or_head"}
    want = {}
    for phase in ("fwd", "bwd_act", "bwd_w"):
        for g in analytical.transformer_gemms(arch, B, S, phase):
            want[bucket[g.layer]] = want.get(bucket[g.layer], 0.0) + g.flops
    for g in analytical.transformer_gemms(arch, B, S, "fwd"):
        if g.layer != "head":            # the blocks' recomputed forward
            want[bucket[g.layer]] += g.flops
    # the MLM transform's dense (D x D, forward and both gradients): BERT's,
    # not a Table 3 row
    want["embed_or_head"] += 3 * 2.0 * B * S * arch.d_model ** 2
    got = _gemm_by(unfused, lambda op: characterize.bucket_of(op.scope))
    assert got == want
    # one GEMM op a Table 3 row a pass (QKV fused, the attention's batched
    # products one bmm each), the recompute's, the MLM dense's three
    rows = sum(g.count for ph in ("fwd", "bwd_act", "bwd_w", "fwd")
               for g in analytical.transformer_gemms(arch, B, S, ph)) \
        - 1 + 3
    assert optrace.categorize_ops(unfused.ops)["gemm"] == rows


def test_split_sums_match_the_cost(unfused):
    flops = {op.index: characterize.price(op)[0] for op in unfused.ops}
    got = characterize.split(unfused.ops, flops)

    def nonzero(d):
        return {k: v for k, v in d.items() if v}
    assert got["category"] == pytest.approx(nonzero(unfused.by_category))
    assert got["bucket"] == pytest.approx(nonzero(
        characterize.bucket_scopes(unfused.by_scope)))
    for key in ("cell", "paper", "pass", "fig4"):
        assert sum(got[key].values()) == pytest.approx(unfused.flops)
    assert got["paper"]["fc"] == got["cell"]["mlp/gemm"]
    assert got["fig4"]["gemm"] == unfused.by_category["gemm"]
    assert set(got["pass"]) == {"fwd", "bwd", "remat"}


def test_backward_and_recompute_keep_the_forward_scope(unfused):
    by = _gemm_by(unfused, lambda op: (characterize.bucket_of(op.scope),
                                       op.phase))
    for b in ("attn_linear", "attn_bgemm", "mlp"):
        assert by[(b, "bwd")] == 2 * by[(b, "fwd")] > 0, b
        assert by[(b, "remat")] == by[(b, "fwd")], b
    assert by[("embed_or_head", "bwd")] == 2 * by[("embed_or_head", "fwd")]
    assert ("embed_or_head", "remat") not in by
    assert {k for k in by if k[0] in ("other", "norm", "loss", "lamb")} \
        == set()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fused_step_kernel_ops_are_the_launch_counts(setup, monkeypatch):
    cost, state = _traced(setup, True, monkeypatch)
    n_leaves = len(tree.leaves(state["params"]))
    want = _chip_smoke().expected_train_launches(setup["t_arch"], n_leaves)
    assert cost.kernels() == want
    for op in cost.ops:
        if op.kernel:
            assert op.category == "fusion" and op.scope.endswith(op.name)
            assert characterize.price(op)[0] == op.stated > 0, op.name
    # the kernels' backward (their plain versions' gradients) keeps the
    # kernel's scope: the post-norm site's is the norm bucket
    assert {characterize.bucket_of(op.scope) for op in cost.ops
            if op.phase == "bwd" and "fused_residual_layernorm" in op.scope
            } == {"norm"}


def test_traced_step_is_bitwise_an_untraced_one(setup, monkeypatch):
    bundle = _bundle(setup["t_arch"], True, monkeypatch)
    params = from_jax_params(setup["t_arch"], setup["params"], device="cpu")
    a, b = bundle.init(params=params), bundle.init(params=params)
    for i in range(2):
        batch = JaxPipeline(JaxDataConfig(
            vocab_size=setup["t_arch"].vocab_size, seq_len=S,
            global_batch=B, objective="mlm", seed=0)).batch(i)
        (_, ma), ops = optrace.record(bundle.eager, a, batch)
        _, mb = bundle.eager(b, batch)
        assert ops and all(torch.equal(ma[k], mb[k]) for k in mb), i
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(x, y)


# ------------------------------------------------- kernels as one op each --

def _kernel_cases():
    from repro_torch.kernels.bias_gelu import ops as gelu
    from repro_torch.kernels.decode_attention import ops as paged
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.fused_lamb import ops as lamb
    from repro_torch.kernels.fused_layernorm import ops as norms
    from repro_torch.kernels.fused_lm_head import ops as head
    from repro_torch.kernels.fused_sampling import ops as sampling
    from repro_torch.kernels.fused_softmax import ops as softmax
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)
    s, v, d = 3, 300, 16
    rows = (torch.arange(s), torch.arange(s, dtype=torch.int32))
    sampler = (torch.full((s,), 0.7), torch.full((s,), 5, dtype=torch.int32),
               torch.full((s,), 0.9))
    pools = (r(10, 4, 2, 8), r(10, 4, 2, 8))
    lamb_args = (r(7, 9), r(7, 9), r(7, 9), torch.rand(7, 9, generator=g),
                 torch.tensor([0.5, 1.1, 1.2]))
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
                 lr=1e-3)
    return {
        "paged_decode_attention": (paged.paged_decode_attention, (
            r(2, 4, 8), *pools, torch.randint(0, 10, (2, 3), generator=g,
                                              dtype=torch.int32),
            torch.tensor([5, 9], dtype=torch.int32)), {}),
        "paged_prefill_attention": (paged.paged_prefill_attention, (
            r(5, 4, 8), *pools, torch.randint(0, 10, (3,), generator=g,
                                              dtype=torch.int32), 3, 8), {}),
        "flash_attention": (flash.flash_attention, (
            r(2, 5, 4, 8), r(2, 12, 2, 8), r(2, 12, 2, 8)),
            dict(causal=True, window=3, q_offset=2, block_kv=5,
                 kv_len=torch.tensor([12, 7]))),
        "filter_logits": (sampling.filter_logits, (r(s, v), *sampler[1:]),
                          {}),
        "draw_tokens": (sampling.draw_tokens, (r(s, v), *rows), {}),
        "head_tokens": (head.head_tokens, (r(s, d), r(d, v), *rows,
                                           *sampler),
                        dict(sampled=True, filtered=True, untied=True)),
        "decode_residual_norm": (norms.decode_residual_norm, (
            r(3, 4, 16), r(3, 4, 16), r(16), r(16)), dict(kind="layernorm")),
        "fused_residual_layernorm": (norms.fused_residual_layernorm, (
            r(3, 4, 16), r(3, 4, 16), r(16)), dict(rms=True)),
        "gated_rmsnorm": (norms.gated_rmsnorm, (r(3, 4, 16), r(3, 4, 16),
                                                r(16)), {}),
        "bias_gelu": (gelu.bias_gelu, (r(3, 4, 16), r(16)), {}),
        "lamb_stage1": (lamb.lamb_update_, lamb_args, hyper),
        "lamb_stage2": (lamb.lamb_update_, lamb_args, hyper),
        "scale_mask_softmax": (softmax.scale_mask_softmax, (r(2, 5, 7),),
                               dict(scale=0.5, causal=True, q_offset=-1)),
    }


KERNELS = ("paged_decode_attention", "paged_prefill_attention",
           "flash_attention", "filter_logits", "draw_tokens", "head_tokens",
           "decode_residual_norm", "fused_residual_layernorm",
           "gated_rmsnorm", "bias_gelu", "lamb_stage1", "lamb_stage2",
           "scale_mask_softmax")


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_stated_flops_are_its_plain_versions(name):
    fn, args, kwargs = _kernel_cases()[name]
    _, ops = optrace.record(fn, *args, **kwargs)
    lamb = name in ("lamb_stage1", "lamb_stage2")
    assert [op.name for op in ops if op.kernel] == (
        ["lamb_stage1", "lamb_stage2"] if lamb else [name])
    op = next(op for op in ops if op.kernel and op.name == name)
    body = sum(characterize.price(b)[0] for b in op.body)
    assert body == op.stated > 0
    assert characterize.price(op) == (body, characterize._nbytes(
        (op.args, op.kwargs)) + characterize._nbytes(op.outputs))


# ---------------------------------------------------- profiler ranges ------

def _range_names(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name() for e in prof.profiler.kineto_results.events()}


def test_scope_without_a_recorder_enters_no_profiler_range(setup):
    from repro_torch.models.layers import apply_mlp, apply_norm
    arch = setup["t_arch"]
    x = torch.randn(2, 4, arch.d_model)
    p = {"w1": torch.randn(arch.d_model, 8), "w2": torch.randn(8,
                                                              arch.d_model)}

    def run():
        with optrace.scope("attn_qkv"):
            apply_norm("layernorm", {"scale": torch.ones(arch.d_model)}, x)
            apply_mlp("gelu", p, x)
    names = _range_names(run)
    assert optrace._ACTIVE is None
    assert not any(n.startswith("optrace#") or n in ("attn_qkv", "mlp",
                                                     "norm") for n in names)
    # with a characterizing profile every op that can launch work has one
    names = _range_names(lambda: optrace.record(run, profile=True))
    assert sum(n.startswith("optrace#") for n in names) >= 4


class _Event:
    def __init__(self, name, dev, corr=0, linked=0, thread=1, start=0,
                 dur=0, user=False):
        self._v = (name, dev, corr, linked, thread, start, dur, user)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def linked_correlation_id(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def start_ns(self):
        return self._v[5]

    def end_ns(self):
        return self._v[5] + self._v[6]

    def duration_ns(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[7]


def test_device_times_give_each_kernel_to_its_launching_op():
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        # thread 1: op range 0 holds aten::mm; op range 2 a hand kernel
        _Event("optrace#0", cpu, corr=900, thread=1, start=100, dur=50),
        _Event("aten::mm", cpu, corr=901, thread=1, start=110, dur=30),
        _Event("cudaLaunchKernel", cpu, corr=7, linked=901, thread=5001,
               start=120, dur=5),
        _Event("optrace#2", cpu, corr=903, thread=1, start=200, dur=10),
        _Event("cudaLaunchKernelExC", cpu, corr=10, linked=0, thread=5001,
               start=205, dur=2),
        # thread 2 (autograd's): op range 1, a driver launch, no runtime call
        _Event("optrace#1", cpu, corr=902, thread=2, start=100, dur=50),
        _Event("aten::mm", cpu, corr=904, thread=2, start=130, dur=10),
        # an op outside every range
        _Event("aten::add", cpu, corr=7000, thread=1, start=300, dur=10),
        _Event("cudaLaunchKernel", cpu, corr=9, linked=7000, thread=5001,
               start=305, dur=5),
        _Event("gemm_kernel", gpu, corr=7, linked=901, start=1000,
               dur=2_000_000),
        _Event("nvjet_kernel", gpu, corr=8, linked=904, start=3_000_000,
               dur=500_000),
        _Event("Memcpy HtoD", gpu, corr=99, linked=903, start=4_000_000,
               dur=250_000),
        _Event("resln_kernel", gpu, corr=10, start=4_500_000, dur=125_000),
        _Event("add_kernel", gpu, corr=9, linked=7000, start=5_000_000,
               dur=100_000),
        _Event("optrace#0", gpu, start=1000, dur=2_000_000),
        _Event("train_step/grads", gpu, start=0, dur=9_000_000),
        _Event("annotation", gpu, start=0, dur=9_000_000, user=True),
    ]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events
    t = optrace.device_times(Prof)
    assert t["per_op"] == {0: 2.0, 1: 0.5, 2: 0.375}
    assert t["busy_ms"] == 2.975 and t["kernels"] == 5
    assert abs(t["unattributed_ms"] - 0.1) < 1e-12
