"""The schedule of the untied LM head's GEMV (``fused_lm_head.ops.
untied_plan``), a pure function of (S, D, V, SMs), on the CPU:

- every vocab column is covered by exactly one CTA, in ascending tiles
  within a CTA, including a V that 64 does not divide (102384);
- at the served shapes on 132 SMs the busiest CTA holds at most 1.10x the
  mean (deepseek-moe-16b 13 tiles against 12.1, internlm2-1.8b 11 against
  10.95, jamba-v0.1-52b 8 against 7.76);
- shared memory stays within the 232,448 bytes a block may use at every D
  of a registered untied config, at S = 1, 8, 16 and 40, with at least 4
  ring stages; S <= 16 is one row group (W read once);
- the plan is the same on every call, and the kernel source counts shared
  memory with the same constants and walks the same tile ranges;
- the panel width follows the tiles a CTA holds, and the widest x the
  plan takes (D 12352) is served;
- a shape the kernel does not take raises.

On a card only (marked ``gpu``): shapes whose own plans take every panel
width, a shallow ring, groups of 8 at a wide D, several row groups and
fewer CTAs than SMs, against the plain version, bitwise on
exact-arithmetic inputs, and the wrapper's refusal of D % 64 != 0. The
card's machine has no JAX: there run
``python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_head_plan.py``.
"""
import re
from pathlib import Path

import pytest
import torch

try:
    from repro.configs import REGISTRY as JAX_REGISTRY
except ImportError:         # the card's machine: no JAX package
    JAX_REGISTRY = {}
from repro_torch.configs import REGISTRY
from repro_torch.kernels.fused_lm_head import ops
from repro_torch.kernels.fused_lm_head import ref

SOURCE = (Path(ops.__file__).parent / "csrc" / "head_tokens.cu").read_text()
SERVED = {"deepseek-moe-16b": (2048, 102400, 13),
          "internlm2-1.8b": (2048, 92544, 11),
          "jamba-v0.1-52b": (4096, 65536, 8)}
UNTIED_WIDTHS = sorted({a.d_model for a in list(REGISTRY.values())
                        + list(JAX_REGISTRY.values())
                        if not a.tie_embeddings})


def test_untied_widths_include_the_served_configs():
    assert {2048, 4096} <= set(UNTIED_WIDTHS)
    assert all(not REGISTRY[n].tie_embeddings
               and (REGISTRY[n].d_model, REGISTRY[n].vocab_size)
               == SERVED[n][:2] for n in SERVED)


@pytest.mark.parametrize("v", [102400, 102384, 92544, 65536, 512, 16])
@pytest.mark.parametrize("n_sm", [132, 114, 7, 1])
def test_every_column_covered_once_in_ascending_tiles(v, n_sm):
    plan = ops.untied_plan(8, 2048, v, n_sm)
    tiles = -(-v // 64)
    assert plan.tile == 64 and (tiles - 1) * 64 < v <= tiles * 64
    assert plan.ctas == min(n_sm, tiles) == len(plan.ranges)
    assert plan.ranges[0][0] == 0 and plan.ranges[-1][1] == tiles
    for (a0, a1), (b0, _) in zip(plan.ranges, plan.ranges[1:]):
        assert a1 == b0
    assert all(a1 > a0 for a0, a1 in plan.ranges)
    cols = [c for a0, a1 in plan.ranges for t in range(a0, a1)
            for c in range(t * 64, min(v, t * 64 + 64))]
    assert cols == list(range(v))
    assert ops.partial_blocks(v, untied=True) == tiles


@pytest.mark.parametrize("name", sorted(SERVED))
def test_busiest_cta_within_a_tenth_of_the_mean_on_132_sms(name):
    d, v, most = SERVED[name]
    plan = ops.untied_plan(8, d, v, 132)
    sizes = [a1 - a0 for a0, a1 in plan.ranges]
    assert plan.ctas == 132 and max(sizes) == most
    assert max(sizes) <= 1.10 * sum(sizes) / len(sizes)
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("s", [1, 8, 16, 40])
@pytest.mark.parametrize("d", UNTIED_WIDTHS)
def test_shared_memory_within_a_block_at_every_untied_width(d, s):
    plan = ops.untied_plan(s, d, 102400, 132)
    assert plan.smem_bytes <= ops.SMEM_BYTES == 232448
    assert plan.smem_bytes == ops.untied_smem(d, plan.rows, plan.panel,
                                              plan.stages)
    assert plan.stages >= ops.UNTIED_MIN_STAGES
    ring = plan.stages * ops.stage_bytes(plan.panel)
    assert ring <= max(ops.UNTIED_RING_BYTES,
                       ops.UNTIED_MIN_STAGES * ops.stage_bytes(plan.panel))
    assert plan.rows in (8, 16) and plan.panel in ops.UNTIED_PANELS
    assert [r for r0, n in plan.groups for r in range(r0, r0 + n)] \
        == list(range(s))
    assert all(0 < n <= plan.rows for _, n in plan.groups)
    if d <= 4096:                          # every config the port serves
        assert ring >= 64 * 1024
        assert plan.rows == (8 if s <= 8 else 16)
        assert len(plan.groups) == -(-s // 16) if s > 8 else 1
    if s <= 16 and d <= 5120:
        assert len(plan.groups) == 1       # W read from HBM once


def test_plan_is_the_same_on_every_call():
    args = (16, 2048, 102384, 132)
    assert ops.untied_plan(*args) == ops.untied_plan(*args)
    assert ops.untied_plan.__wrapped__(*args) == ops.untied_plan(*args)
    assert ops.untied_plan(*args).stages == 4


def test_kernel_source_counts_shared_memory_as_the_plan():
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE))
    assert int(consts["kTile"]) == ops.UNTIED_TILE
    assert int(consts["kBK"]) == ops.UNTIED_BK
    assert int(consts["kTRowBytes"]) == ops.UNTIED_TILE * 2
    assert int(consts["kSmemLimit"]) == ops.SMEM_BYTES
    body = re.search(r"inline size_t untied_smem\(.*?\{(.*?)\}", SOURCE,
                     re.S).group(1)
    assert "1024 +" in body and "* rows * 2" in body
    assert "stage_bytes(panel)" in body and "8 * (2 * stages + 2)" in body
    assert "static_cast<size_t>(panel) * rows * 4 * 5" in body
    assert "constexpr int kBox = kBK * kTRowBytes;" in SOURCE
    assert re.search(r"constexpr int stage_bytes\(int panel\) \{\s*"
                     r"return panel \* kBox;\s*\}", SOURCE)
    assert ops.stage_bytes(16) == 16 * 16 * 128
    # the launch takes exactly the plan's panel widths
    cases = re.findall(r"case (\d+): return run_untied<N, (\d+)>", SOURCE)
    assert all(a == b for a, b in cases) and \
        sorted(int(a) for a, _ in cases) == list(ops.UNTIED_PANELS)


def test_kernel_walks_the_plans_tile_ranges():
    """The kernel computes CTA c's range [c T / G, (c + 1) T / G) from its
    block index over a grid of ``plan.ctas``; it must be the plan's."""
    flat = re.sub(r"\s+", " ", SOURCE)
    for lo, first in (("t0", "blockIdx.x"), ("t1", "blockIdx.x + 1")):
        assert (f"const int {lo} = static_cast<int>(static_cast<long long>"
                f"({first}) * a.n_tiles / gridDim.x);") in flat
    assert "<<<ctas, kTThreads, smem, st>>>" in SOURCE
    plan = ops.untied_plan(8, 2048, 102384, 132)
    tiles = -(-102384 // 64)
    assert plan.ranges == tuple((c * tiles // plan.ctas,
                                 (c + 1) * tiles // plan.ctas)
                                for c in range(plan.ctas))


@pytest.mark.parametrize("s,d,v", [(8, 2047, 1024), (8, 2048, 1000),
                                   (0, 2048, 1024), (8, 12416, 1024)])
def test_plan_refuses_shapes_the_kernel_does_not_take(s, d, v):
    with pytest.raises(ValueError):
        ops.untied_plan(s, d, v, 132)


def test_wider_x_falls_back_to_groups_of_8():
    plan = ops.untied_plan(16, 12288, 32768, 132)
    assert plan.rows == 8 and plan.groups == ((0, 8), (8, 8))
    assert plan.stages == ops.UNTIED_MIN_STAGES


def test_the_widest_x_the_plan_takes():
    plan = ops.untied_plan(1, 12352, 102400, 132)
    assert (plan.rows, plan.panel, plan.stages) == (8, 4, 4)
    assert plan.smem_bytes <= ops.SMEM_BYTES


@pytest.mark.parametrize("v,most,panel", [
    (512, 1, 4), (4096, 1, 4), (16384, 2, 4), (32768, 4, 4), (50304, 6, 8),
    (65536, 8, 8), (92544, 11, 16), (102400, 13, 16), (262144, 32, 16)])
def test_panel_is_the_least_width_that_holds_a_range(v, most, panel):
    plan = ops.untied_plan(8, 2048, v, 132)
    assert max(b - a for a, b in plan.ranges) == most
    assert plan.panel == panel


@pytest.mark.parametrize("name", sorted(SERVED))
def test_a_stage_holds_the_whole_range_at_the_served_shapes(name):
    """At the served shapes every CTA's range fits one panel, so the CTAs
    read whole K rows of W at a time; jamba's [16, 4096] keeps its 16 rows
    in one group (W read once) with a panel of 8."""
    d, v, most = SERVED[name]
    for s in (1, 8, 16):
        plan = ops.untied_plan(s, d, v, 132)
        assert plan.panel >= most and len(plan.groups) == 1
        assert plan.panel == (16 if most > 8 else 8)


# ------------------------------------------------------------- on a card ----

def _exact(s, d, v):
    gen = torch.Generator(device="cuda").manual_seed(s * 7 + v)
    x = torch.randint(-3, 4, (s, d), generator=gen, device="cuda")
    w = torch.randint(-3, 4, (d, v), generator=gen, device="cuda")
    return (x * 0.125).bfloat16(), (w * 0.0625).bfloat16()


# (S, D, V) and the plan each takes on 132 SMs: (rows, panel, stages,
# groups, CTAs); every panel width, a ring of 4 stages, groups of 8 at a wide
# D, several groups (one ragged) and fewer CTAs than SMs
CARD_SHAPES = {(8, 2048, 4096): (8, 4, 24, 1, 64),
               (3, 2048, 16384): (8, 4, 24, 1, 132),
               (24, 2048, 32768): (16, 4, 20, 2, 132),
               (8, 2048, 65536): (8, 8, 12, 1, 132),
               (16, 2048, 102384): (16, 16, 4, 1, 132),
               (16, 4096, 65536): (16, 8, 5, 1, 132),
               (40, 12288, 32768): (8, 4, 4, 5, 132),
               (1, 128, 512): (8, 4, 24, 1, 8)}


@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_card_shapes_take_the_plans_they_are_meant_to(shape):
    plan = ops.untied_plan(*shape, 132)
    assert (plan.rows, plan.panel, plan.stages, len(plan.groups),
            plan.ctas) == CARD_SHAPES[shape]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_plans_match_plain_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    s, d, v = shape
    x, w = _exact(s, d, v)
    seeds = torch.arange(s, dtype=torch.int64, device="cuda") * 7919
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    temps = torch.zeros((s,), device="cuda")
    top_k = torch.zeros((s,), dtype=torch.int32, device="cuda")
    top_p = torch.ones((s,), device="cuda")
    tok, ok = ops.head_tokens(x, w, seeds, pos, temps, top_k, top_p,
                              sampled=False, filtered=False, untied=True)
    want = ref.head_tokens(x, w, ref.row_uniforms(seeds, pos), temps, top_k,
                           top_p, sampled=False, filtered=False, untied=True)
    assert torch.equal(tok, want[0]) and torch.equal(ok, want[1])


@pytest.mark.gpu
def test_wrapper_refuses_d_not_a_multiple_of_64_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x = torch.zeros((8, 2000), dtype=torch.bfloat16, device="cuda")
    w = torch.zeros((2000, 1024), dtype=torch.bfloat16, device="cuda")
    keys = (torch.zeros((8,), dtype=torch.int64, device="cuda"),
            torch.zeros((8,), dtype=torch.int32, device="cuda"))
    row = (torch.zeros((8,), device="cuda"),
           torch.zeros((8,), dtype=torch.int32, device="cuda"),
           torch.ones((8,), device="cuda"))
    with pytest.raises(ValueError, match="D % 64"):
        ops.head_tokens(x, w, *keys, *row, sampled=False, filtered=False,
                        untied=True)
