"""The training step over static buffers (``train.steps.StepGraph``, the
route ``bundle.fn`` takes; on the card one CUDA-graph replay a step) and
the bias + GeLU kernel's form and grid, on the CPU at bert-large-smoke
(2 layers, d_model 128), B2 / S32, seeded weights:

- ``bundle.fn`` equals ``bundle.eager`` bitwise over 3 steps (metrics,
  parameters, ``m``, ``v``, ``master``), the fused blocks and the fused
  LAMB path on and off;
- ``train_loop`` over ``bundle.fn`` records each step's own metrics,
  though the step writes them into one buffer that the next step
  overwrites;
- a capture's launch counts are taken back and each replay adds them
  (``repro_torch.graphs``, against a stub graph: none can be captured
  here);
- the GeLU form the kernel evaluates (``ref.gelu_as_sigmoid``) in fp32
  within the chip gate (1 bf16 ulp + |h| 2^-22) of the plain version in
  float64 over h in [-12, 12], and ``ops.gelu_plan`` covering every chunk
  once with a grid sized to the SMs.

The ``gpu``-marked tests (the kernel on tail-heavy inputs; the graphed
step against the eager one on the card, bitwise, with exact launch counts
a step) skip here. This file imports no JAX, so they run on the card:
``python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_training_graph.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import graphs, tree
from repro_torch.configs import RunConfig, ShapeConfig, smoke_config
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.kernels.bias_gelu import ops as bg_ops
from repro_torch.kernels.bias_gelu import ref as bg_ref
from repro_torch.kernels.fused_lamb import ops as lamb_ops
from repro_torch.kernels.fused_layernorm import ops as ln_ops
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.steps import build_train_step

torch.set_num_threads(2)

B, S, STEPS = 2, 32, 3
GELU_TAIL = 2.0 ** -22


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    mag = t.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _setup(arch, fused: bool, device: str):
    run = RunConfig(arch=arch, shape=ShapeConfig("t", S, B, "train"),
                    zero1=False, fused_optimizer_kernel=fused)
    bundle = build_train_step(run, device=device)
    data = SyntheticPipeline(DataConfig(vocab_size=arch.vocab_size,
                                        seq_len=S, global_batch=B,
                                        objective="mlm", seed=1))
    return bundle, data


def _assert_states_equal(a, b):
    for part in ("params", "opt"):
        la, lb = tree.leaves(a[part]), tree.leaves(b[part])
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            assert torch.equal(x, y), part


@pytest.mark.parametrize("fused", ["0", "1"])
def test_static_buffer_step_equals_the_eager_step_bitwise(fused,
                                                          monkeypatch):
    monkeypatch.setenv("REPRO_FUSED_BLOCKS", fused)
    bundle, data = _setup(smoke_config("bert-large"), fused == "1", "cpu")
    graphed, eager = bundle.init(0), bundle.init(0)
    for step in range(STEPS):
        batch = data.batch(step)
        _, got = bundle.fn(graphed, batch)
        _, want = bundle.eager(eager, batch)
        assert list(got) == ["loss", "ce", "aux", "accuracy", "grad_norm"]
        for k in want:
            assert torch.equal(got[k], want[k]), (step, k)
    assert set(graphed["opt"]) == {"m", "v", "master", "step"}
    _assert_states_equal(graphed, eager)
    assert bundle.fn.captures == bundle.fn.replays == 0     # no card here


def test_train_loop_keeps_each_steps_metrics_from_a_reused_buffer():
    """``bundle.fn`` writes every step's metrics into one static buffer;
    ``train_loop`` reads step k's only after step k+1 has run, so each
    call must hand back its own copy."""
    bundle, data = _setup(smoke_config("bert-large"), False, "cpu")
    state = bundle.init(0)
    out = train_loop(bundle.fn, state, data, LoopConfig(max_steps=STEPS),
                     log=lambda s: None)
    eager = bundle.init(0)
    it = data.iterator()
    for h in out["history"]:
        _, m = bundle.eager(eager, next(it))
        assert h["loss"] == float(m["loss"]), h["step"]
        assert h["grad_norm"] == float(m["grad_norm"]), h["step"]
    first = bundle.fn(state, data.batch(STEPS))[1]
    kept = float(first["loss"])
    bundle.fn(state, data.batch(STEPS + 1))
    assert float(first["loss"]) == kept
    assert bundle.fn.out.data_ptr() != first["loss"].data_ptr()


def test_capture_counts_are_taken_back_and_each_replay_adds_them():
    """What a captured fused step counts, recorded into a stub graph: the
    capture leaves every counter as it was; each replay adds 48 GeLUs, 96
    norms and 296 launches of each LAMB stage (bert-large's step)."""
    class StubGraph:
        replays = 0

        def replay(self):
            self.replays += 1
    per_step = {"bias_gelu": 48, "fused_residual_layernorm": 96,
                "lamb_stage1": 296, "lamb_stage2": 296}

    def record():
        bg_ops.LAUNCHES["bias_gelu"] += 48
        ln_ops.LAUNCHES["fused_residual_layernorm"] += 96
        for k in ("lamb_stage1", "lamb_stage2"):
            lamb_ops.LAUNCHES[k] += 296
    before = [dict(d) for d in graphs.launch_counters()]
    launches = graphs.counted(record)
    assert launches == per_step
    assert [dict(d) for d in graphs.launch_counters()] == before
    entry = graphs.Captured(StubGraph(), launches)
    graphs.replay(entry, 3)
    graphs.replay(entry, 0)
    assert entry.graph.replays == 3
    now = {k: v for d in graphs.launch_counters() for k, v in d.items()}
    was = {k: v for d in before for k, v in d.items()}
    assert {k: now[k] - was[k] for k in now if now[k] != was[k]} == {
        k: 3 * n for k, n in per_step.items()}
    for d, w in zip(graphs.launch_counters(), before):
        d.update(w)


def test_gelu_as_sigmoid_is_within_the_chip_gate():
    """h sigmoid(2u), the kernel's form, in fp32 and rounded to bf16 as
    the kernel writes it, against 0.5 h (1 + tanh(u)) in float64."""
    h = torch.linspace(-12.0, 12.0, 1_000_001, dtype=torch.float64)
    want = bg_ref.bias_gelu(h)
    got = bg_ref.gelu_as_sigmoid(h.float()).bfloat16().double()
    tol = _bf16_ulp(want) + h.abs() * GELU_TAIL
    assert ((got - want).abs() <= tol).all()
    # no cancellation in the tail: on fp32 inputs the fp32 form is within
    # 2^-14 relative (the exponent's own rounding, up to |2u| ~ 90 here) of
    # the same function in float64 wherever the result is far from fp32's
    # subnormals; 1 + tanh(u) in fp32 loses every bit there (and in
    # float64 from |u| ~ 19)
    h32 = h.float()
    exact = bg_ref.gelu_as_sigmoid(h32.double())
    far = exact.abs() >= 2.0 ** -100
    rel = (bg_ref.gelu_as_sigmoid(h32).double() - exact).abs() / exact.abs()
    assert rel[far].max().item() <= 2.0 ** -14
    rel_tanh = (bg_ref.bias_gelu(h32).double() - exact).abs() / exact.abs()
    assert rel_tanh[far].max().item() > 0.5


@pytest.mark.parametrize("rows,f", [(1024, 4096), (4096, 4096), (64, 256),
                                    (300, 512), (7, 8), (5, 4104)])
def test_gelu_plan_covers_every_chunk_once(rows, f):
    sms = 132
    p = bg_ops.gelu_plan(rows, f, sms)
    assert p.tx % 32 == 0 and p.tx * p.ty <= bg_ops.THREADS
    assert p.gx * p.tx * 8 >= f > (p.gx - 1) * p.tx * 8
    assert p.rows_per_thread % bg_ops.ROWS_IN_FLIGHT == 0
    span = p.ty * p.rows_per_thread         # rows a CTA row of the grid
    assert p.gy * span >= rows > (p.gy - 1) * span
    assert p.gx * p.gy <= max(sms * bg_ops.CTAS_PER_SM, p.gx)
    # every (row, chunk) owned by exactly one thread
    owned = np.zeros((rows, -(-f // 8)), dtype=np.int64)
    for cy in range(p.gy):
        for ty in range(p.ty):
            r0 = (cy * p.ty + ty) * p.rows_per_thread
            for cx in range(p.gx):
                c = cx * p.tx + np.arange(p.tx)
                c = c[c < f // 8]
                owned[r0:min(rows, r0 + p.rows_per_thread), c] += 1
    assert (owned == 1).all()


# ------------------------------------------------------------- on a card ----

def _card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card (sm_90a)")


@pytest.mark.gpu
@pytest.mark.parametrize("rows,f,bias", [(1024, 4096, "bf16"),
                                         (300, 512, "fp32"),
                                         (33, 4104, None)])
def test_bias_gelu_kernel_on_tail_heavy_inputs_on_card(rows, f, bias):
    """h = x + b spread over [-12, 12]: the kernel within 1 bf16 ulp +
    |h| 2^-22 of the plain version in fp32 on the same inputs."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(rows)
    b = None if bias is None else (0.5 * torch.randn(
        (f,), generator=g, device="cuda")).to(
        torch.bfloat16 if bias == "bf16" else torch.float32)
    bb = 0 if b is None else b.float()
    x = (24 * torch.rand((rows, f), generator=g, device="cuda") - 12
         - bb).bfloat16()
    n = bg_ops.LAUNCHES["bias_gelu"]
    y = bg_ops.bias_gelu(x, b).double()
    assert bg_ops.LAUNCHES["bias_gelu"] == n + 1
    h = (x.float() + bb).double()
    p = bg_ref.bias_gelu(h.float()).bfloat16().double()
    assert h.min() < -11 and h.max() > 11
    assert ((y - p).abs() <= _bf16_ulp(p) + h.abs() * GELU_TAIL).all()


@pytest.mark.gpu
def test_graphed_step_equals_the_eager_step_on_card(monkeypatch):
    """Four fused steps replayed from a captured graph against four eager
    steps from the same weights and batches: bitwise equal metrics and
    state, the capture's launches taken back and each replay counted."""
    _card()
    monkeypatch.setenv("REPRO_FUSED_BLOCKS", "1")
    arch = dataclasses.replace(smoke_config("bert-large"), d_model=256,
                               d_ff=1024, num_heads=4, num_kv_heads=4,
                               head_dim=64)
    bundle, data = _setup(arch, True, "cuda")
    graphed, eager = bundle.init(0), bundle.init(0)
    counters = (ln_ops.LAUNCHES, bg_ops.LAUNCHES, lamb_ops.LAUNCHES)
    per_step = {"fused_residual_layernorm": 4 * arch.num_layers,
                "bias_gelu": 2 * arch.num_layers,
                "lamb_stage1": len(tree.leaves(graphed["params"])),
                "lamb_stage2": len(tree.leaves(graphed["params"]))}
    for step in range(4):
        batch = data.batch(step)
        before = {k: v for d in counters for k, v in d.items()}
        _, got = bundle.fn(graphed, batch)
        after = {k: v for d in counters for k, v in d.items()}
        assert {k: after[k] - before[k] for k in per_step} == per_step, step
        assert all(after[k] == before[k] for k in after if k not in per_step)
        _, want = bundle.eager(eager, batch)
        for k in want:
            assert torch.equal(got[k], want[k]), (step, k)
    torch.cuda.synchronize()
    assert (bundle.fn.captures, bundle.fn.replays) == (1, 3)
    _assert_states_equal(graphed, eager)
