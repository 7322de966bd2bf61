"""The port's analytical model (``repro_torch.core``) against the JAX
package's (``repro.core``): the parameter count, Table 3's GEMMs in all
three phases, the non-GEMM phases, the per-bucket times on the paper's GPU,
Fig. 12's distributed profiles, ``model_flops`` and the roofline terms,
for bert-large, llama3.2-3b, mamba2-1.3b, their smoke configs and a hybrid
stack without MoE. The arithmetic runs in the same order on both sides, so
every value is compared with ``==``. Then the paper's takeaways of
``tests/test_system.py`` on the port, and the port's device specs."""
import dataclasses

import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.core import analytical as janalytical
from repro.core import distmodel as jdistmodel
from repro.core import roofline as jroofline
from repro.core.hlotext import CollectiveOp, CollectiveSummary
from repro_torch.configs import ShapeConfig, get_config, smoke_config
from repro_torch.core import analytical, distmodel, roofline

NAMES = ("bert-large", "llama3.2-3b", "mamba2-1.3b")
HYBRID = dict(family="hybrid", hybrid_period=4, hybrid_attn_index=1,
              num_heads=4, num_kv_heads=2, d_ff=256)


def _pair(name, smoke):
    if name == "hybrid":
        return (dataclasses.replace(jax_smoke_config("mamba2-1.3b"),
                                    num_layers=8, **HYBRID),
                dataclasses.replace(smoke_config("mamba2-1.3b"),
                                    num_layers=8, **HYBRID))
    if smoke:
        return jax_smoke_config(name), smoke_config(name)
    return jax_get_config(name), get_config(name)


ARCHS = [(n, s) for n in NAMES for s in (False, True)] + [("hybrid", True)]
IDS = [f"{n}{'-smoke' if s else ''}" for n, s in ARCHS]
SIZES = [(1, 128), (4, 512), (32, 128)]
DEVICES = [(jroofline.MI100, roofline.MI100),
           (jroofline.MI100_FP32, roofline.MI100_FP32)]


def _fields(objs):
    return [dataclasses.asdict(o) for o in objs]


@pytest.mark.parametrize("name,smoke", ARCHS, ids=IDS)
def test_param_count_matches_jax(name, smoke):
    jarch, arch = _pair(name, smoke)
    for active in (False, True):
        assert arch.param_count(active) == jarch.param_count(active)


@pytest.mark.parametrize("name,smoke", ARCHS, ids=IDS)
def test_inventory_matches_jax(name, smoke):
    """Every GEMM of every phase and every non-GEMM phase, field by field,
    with the derived flops, bytes and intensities."""
    jarch, arch = _pair(name, smoke)
    for b, n in SIZES:
        for phase in ("fwd", "bwd_act", "bwd_w"):
            got = analytical.transformer_gemms(arch, b, n, phase)
            want = janalytical.transformer_gemms(jarch, b, n, phase)
            assert _fields(got) == _fields(want), phase
            assert [(g.flops, g.bytes_(4), g.intensity(2)) for g in got] == \
                [(g.flops, g.bytes_(4), g.intensity(2)) for g in want]
        for db in (2, 4):
            got = analytical.nongemm_ops(arch, b, n, db)
            want = janalytical.nongemm_ops(jarch, b, n, db)
            assert _fields(got) == _fields(want)
            assert [(e.total_flops, e.total_bytes, e.intensity)
                    for e in got] == [(e.total_flops, e.total_bytes,
                                       e.intensity) for e in want]
        assert analytical.total_flops(arch, b, n) == \
            janalytical.total_flops(jarch, b, n)


@pytest.mark.parametrize("name,smoke", ARCHS, ids=IDS)
def test_phase_times_match_jax(name, smoke):
    jarch, arch = _pair(name, smoke)
    for jdev, dev in DEVICES:
        for b, n in SIZES:
            for db in (2, 4):
                for train in (True, False):
                    assert analytical.phase_times(arch, b, n, dev, db,
                                                  train) == \
                        janalytical.phase_times(jarch, b, n, jdev, db, train)


@pytest.mark.parametrize("name", NAMES)
def test_figure12_matches_jax(name):
    jarch, arch = _pair(name, False)
    got, want = distmodel.figure12(arch), jdistmodel.figure12(jarch)
    assert list(got) == list(want)
    for key in want:
        assert dataclasses.asdict(got[key]) == dataclasses.asdict(want[key])
        assert got[key].total == want[key].total
        assert got[key].breakdown() == want[key].breakdown()
    assert distmodel.ring_allreduce_time(1e9, 8, 32e9) == \
        jdistmodel.ring_allreduce_time(1e9, 8, 32e9)


SHAPES = [("train", 128, 32), ("prefill", 2048, 4), ("decode", 4096, 64)]


@pytest.mark.parametrize("name,smoke", ARCHS, ids=IDS)
def test_model_flops_and_roofline_terms_match_jax(name, smoke):
    jarch, arch = _pair(name, smoke)
    assert roofline.matmul_params(arch) == jroofline.matmul_params(jarch)
    colls = CollectiveSummary([
        CollectiveOp("all-reduce", 4096, 4096, 4, False, "ar"),
        CollectiveOp("all-gather", 8192, 2048, 4, True, "ag")])
    for kind, seq, batch in SHAPES:
        shape = ShapeConfig(kind, seq, batch, kind)
        jshape = JaxShape(kind, seq, batch, kind)
        assert roofline.model_flops(arch, shape) == \
            jroofline.model_flops(jarch, jshape)
        kw = dict(flops_per_device=3.1e12, bytes_per_device=2.2e10,
                  n_devices=4)
        got = roofline.compute_terms(
            colls=roofline.Collectives(colls.operand_bytes,
                                       colls.wire_bytes_ici,
                                       colls.wire_bytes_dcn),
            arch=arch, shape=shape, dev=roofline.MI100, **kw)
        want = jroofline.compute_terms(colls=colls, arch=jarch, shape=jshape,
                                       dev=jroofline.MI100, **kw)
        assert got.to_dict() == want.to_dict()


def test_other_families_raise():
    """(Name kept from when encdec still raised.) The moe family counts as
    ``repro`` counts it (deepseek, jamba and internlm2 are held under
    ``==`` in ``test_torch_moe.py``), and so does encdec now: whisper's
    encoder and cross-attention in ``param_count``, ``transformer_gemms``
    and ``nongemm_ops``, under ``==``."""
    jarch, arch = (dataclasses.replace(get("deepseek-moe-16b"),
                                       num_layers=3)
                   for get in (jax_smoke_config, smoke_config))
    for active in (False, True):
        assert arch.param_count(active) == jarch.param_count(active)
    assert arch.param_count(active_only=True) < arch.param_count()
    assert [dataclasses.astuple(g) for g in
            analytical.transformer_gemms(arch, 2, 16)] == \
        [dataclasses.astuple(g) for g in
         janalytical.transformer_gemms(jarch, 2, 16)]
    jenc, enc = (dataclasses.replace(a, family="encdec", moe=None,
                                     enc_layers=3, enc_seq_len=16)
                 for a in (jarch, arch))
    assert enc.param_count() == jenc.param_count() > \
        dataclasses.replace(enc, enc_layers=0).param_count()
    for fn, jfn in ((analytical.transformer_gemms,
                     janalytical.transformer_gemms),
                    (analytical.nongemm_ops, janalytical.nongemm_ops)):
        assert [dataclasses.astuple(r) for r in fn(enc, 2, 16)] == \
            [dataclasses.astuple(r) for r in jfn(jenc, 2, 16)]


def test_h100_is_the_default_and_v5e_is_not_ported():
    assert roofline.DeviceSpec() == roofline.H100
    assert (roofline.H100.peak_flops, roofline.H100.hbm_bw,
            roofline.H100.hbm_bytes) == (989e12, 3.35e12, 80e9)
    assert (roofline.H100.ici_bw, roofline.H100.dcn_bw) == (450e9, 50e9)
    assert (roofline.H100.kernel_overhead,
            roofline.H100.ew_bw_efficiency) == (0.0, 1.0)
    assert roofline.H100_FP32.peak_flops == 67e12
    assert roofline.H100_FP32.hbm_bw == roofline.H100.hbm_bw
    assert not hasattr(roofline, "V5E")
    arch = get_config("bert-large")
    assert analytical.phase_times(arch, 4, 512) == \
        analytical.phase_times(arch, 4, 512, roofline.H100)
    for jdev, dev in DEVICES:
        assert dataclasses.asdict(dev) == dataclasses.asdict(jdev)


# ------------------------------------- the paper's takeaways, on the port ---

BERT = get_config("bert-large")
MI100, MI100_FP32 = roofline.MI100, roofline.MI100_FP32
GEMM_BUCKETS = ("attn_linear", "attn_bgemm", "fc", "head")


def _shares(b, n, dev, db, arch=BERT):
    times = analytical.phase_times(arch, b, n, dev=dev, dtype_bytes=db)
    tot = sum(times.values())
    gemm = sum(v for k, v in times.items() if k in GEMM_BUCKETS) / tot
    return times, tot, gemm


def _takeaway_1():
    times, tot, _ = _shares(32, 128, MI100_FP32, 4)
    transformer = sum(v for k, v in times.items()
                      if k not in ("lamb", "loss", "head"))
    assert transformer / tot > 0.7


def _takeaway_2():
    t32, tot32, _ = _shares(32, 128, MI100_FP32, 4)
    t4, tot4, _ = _shares(4, 128, MI100_FP32, 4)
    assert t4["lamb"] / tot4 > t32["lamb"] / tot32
    assert t4["lamb"] / tot4 > 0.1


def _takeaway_3():
    t32, tot32, _ = _shares(32, 128, MI100_FP32, 4)
    tmp, totmp, _ = _shares(32, 128, MI100, 2)
    assert tmp["lamb"] / totmp > t32["lamb"] / tot32


def _takeaway_4():
    times, _, gemm = _shares(32, 128, MI100_FP32, 4)
    assert times["fc"] > times["attn_linear"] > times["attn_bgemm"]
    assert gemm > 0.5


def _takeaway_5():
    _, _, g32 = _shares(32, 128, MI100_FP32, 4)
    _, _, gmp = _shares(32, 128, MI100, 2)
    assert (1 - gmp) > (1 - g32)


def _takeaway_6():
    for g in analytical.transformer_gemms(BERT, 1, 128):
        assert g.m > 1 and g.n > 1, (g.name, g.m, g.n)


def _takeaway_7():
    gs = {g.name: g for g in analytical.transformer_gemms(BERT, 32, 128)}
    balance = MI100_FP32.peak_flops / MI100_FP32.hbm_bw
    assert gs["attn_score"].intensity(4) < balance
    assert gs["fc1"].intensity(4) > balance


def _takeaway_8():
    ops = analytical.nongemm_ops(BERT, 32, 128)
    stage1 = next(e for e in ops if e.name == "lamb_stage1")
    assert stage1.total_bytes >= 4 * BERT.param_count() * 4   # w, g, m, v
    assert stage1.intensity < 1.0


def _takeaway_9():
    _, _, gemm = _shares(32, 128, MI100_FP32, 4)
    assert 0.1 < 1 - gemm < 0.45


def _takeaway_11():
    t_small, tot_small, _ = _shares(4, 128, MI100_FP32, 4)
    t_big, tot_big, _ = _shares(32, 512, MI100_FP32, 4)
    assert t_small["lamb"] / tot_small > 3 * (t_big["lamb"] / tot_big)


def _takeaway_13():
    def gemm_share(width):
        arch = dataclasses.replace(BERT, d_model=width, d_ff=4 * width,
                                   head_dim=width // 16)
        return _shares(32, 128, MI100_FP32, 4, arch)[2]
    assert gemm_share(4096) > gemm_share(1024) > gemm_share(768)


def _takeaway_14():
    profs = distmodel.figure12(BERT)
    d1 = profs["D1 (DP64 B=16, overlap)"]
    d2 = profs["D2 (DP64 B=16, no overlap)"]
    s1 = profs["S1 (single, B=16)"]
    assert d1.total < 1.1 * s1.total
    assert d2.comm_time > 5 * d1.comm_time


def _takeaway_15():
    profs = distmodel.figure12(BERT)
    m1, m2 = profs["M1 (MP2, B=16)"], profs["M2 (MP8, B=64)"]
    assert m2.breakdown()["lamb"] < m1.breakdown()["lamb"]
    assert m2.comm_time > m1.comm_time
    assert m2.comm_time / m2.total > 0.3


TAKEAWAYS = {n: f for n, f in globals().items() if n.startswith("_takeaway_")}


@pytest.mark.parametrize("name", list(TAKEAWAYS),
                         ids=[n.lstrip("_") for n in TAKEAWAYS])
def test_paper_takeaway_holds_on_the_port(name):
    TAKEAWAYS[name]()
