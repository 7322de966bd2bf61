"""Row 11's split entries (``gated_rmsnorm_partial``, ``gated_rmsnorm_apply``
of ``kernels/fused_layernorm/csrc/gated_rmsnorm.cu``) against their plain
versions on a card (``gpu``; skips without one). No JAX here: the machine
with the card has none. Run there with ``PYTHONPATH=src python -m pytest
--noconftest -p no:cacheprovider -m gpu tests/test_torch_gated_split_gpu.py``.
"""
import pytest
import torch

from repro_torch.kernels.fused_layernorm import ops as ln_ops
from repro_torch.kernels.fused_layernorm import ref as ln_ref


@pytest.mark.gpu
@pytest.mark.parametrize("rows,c", [(1024, 2048), (300, 4096), (8, 2048)])
def test_split_kernels_match_plain_on_card(rows, c):
    """``gated_rmsnorm_partial`` within 1e-5 relative of its plain row
    sums; ``gated_rmsnorm_apply`` on the summed statistic of a row of 2 C
    columns within 1 bf16 ulp of the row's largest |output| of its plain
    version; z read in place from an in_proj row; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card (sm_90a)")
    g = torch.Generator(device="cuda").manual_seed(rows)
    proj = torch.randn((rows, 2 * c + 160), generator=g,
                       device="cuda").bfloat16()
    y = torch.randn((rows, c), generator=g, device="cuda").bfloat16()
    scale = (1 + 0.1 * torch.randn((c,), generator=g, device="cuda")
             ).bfloat16()
    z = proj[:, :c]
    n = dict(ln_ops.LAUNCHES)
    sq = ln_ops.gated_rmsnorm_partial(y, z)
    want = ln_ref.gated_rmsnorm_partial(y, z)
    assert bool(((sq - want).abs() <= 1e-5 * want.abs()).all())
    total = 2 * sq          # another rank's share, as large
    out = ln_ops.gated_rmsnorm_apply(y, z, total, scale, c=2 * c)
    plain = ln_ref.gated_rmsnorm_apply(y, z, total, scale, 2 * c).float()
    assert ln_ops.LAUNCHES["gated_rmsnorm_partial"] == \
        n["gated_rmsnorm_partial"] + 1
    assert ln_ops.LAUNCHES["gated_rmsnorm_apply"] == \
        n["gated_rmsnorm_apply"] + 1
    row_max = plain.abs().amax(dim=-1, keepdim=True).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(row_max)) - 7)
    assert bool(((out.float() - plain).abs() <= ulp).all())
