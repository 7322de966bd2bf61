"""Tensor-parallel continuous serving in the port, the counterpart of
``tests/test_tp_serving.py``: ranks of a gloo group on the CPU, one
process each (``launch.mesh.spawn``; one spawn at tp=2 and one at tp=4 run
the whole matrix, each rank serving every job in turn through
``launch.serve.serve_jobs``), in float32 (as JAX's parity tests: bf16's
reassociated reduce flips near-tied draws of random smoke weights, which is
rounding, not layout).

- Every rank's streams equal rank 0's, and rank 0's equal the port's tp=1
  engine's and the JAX package's tp=1 ``ContinuousEngine``'s on the same
  weights: llama (``num_kv_heads=4``) with mixed greedy and seeded
  top-k / top-p traffic at tp 2 and 4, fused decode on and off; a starved
  pool at tp=2 (forced-replay preemption and a copy-on-write tail);
  the reference sampler against the filter kernel's plain version; N=4
  decode steps against N=1; KV-head replication at tp=4 over 2 KV heads;
  deepseek-moe (expert-parallel), jamba (mamba replicated) and qwen2-vl
  (fused qkv split, one KV head replicated) at tp=2.
- ``collective_bytes`` is JAX's formula and ``tp_stats()`` has JAX's keys.
- The rejections carry JAX's messages and come before any group is made;
  a rank refuses a model that holds whole blocks; a rank's sharded
  init holds the whole model's slices bit for bit and only its share of
  the blocks' bytes; ``split_fused_qkv`` is exact; the spec tables and pool specs are JAX's
  layout; ``launch.serve --tp 2 --device cpu`` serves and prints rank 0's
  line.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro_torch import tree
from repro_torch.configs import smoke_config
from repro_torch.launch import mesh, serve
from repro_torch.models import attention as tattn
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tf
from repro_torch.models.convert import to_jax_layout
from repro_torch.models.model import Model
from repro_torch.parallel import sharding as sh
from repro_torch.serving import ContinuousEngine, Request, SamplingParams
from repro_torch.serving.engine import _check_shard

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ENGINE = dict(num_slots=4, num_pages=64, page_size=8, max_seq_len=64)
STARVED = dict(num_slots=2, num_pages=10, page_size=4, max_seq_len=40)
_CACHE = {}


def _fp32(arch, **kw):
    return dataclasses.replace(arch, dtype="float32", param_dtype="float32",
                               **kw)


def _archs(name, **kw):
    return _fp32(jax_smoke_config(name), **kw), _fp32(smoke_config(name),
                                                      **kw)


def _params(t_arch):
    """The port's seeded fp32 weights (the one set both frameworks use)."""
    return model_lib.init_params(t_arch, torch.Generator().manual_seed(0),
                                 "cpu", torch.float32)


def _mixed(vocab):
    """JAX's parity trace: five requests, greedy and seeded top-k / top-p
    sampled in turn."""
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(5, vocab, int(rng.integers(4, 14)))))
               for _ in range(5)]
    gens = [int(rng.integers(3, 9)) for _ in range(5)]
    sps = [SamplingParams() if i % 2 == 0 else
           SamplingParams(temperature=0.8, top_k=12, top_p=0.9, seed=100 + i)
           for i in range(5)]
    return [Request(uid=i, prompt=prompts[i], max_new_tokens=gens[i],
                    sampling=sps[i]) for i in range(5)]


def _starved(vocab):
    """JAX's starved-pool trace: a shared 10-token prefix, sampled."""
    rng = np.random.default_rng(37)
    shared = list(map(int, rng.integers(5, vocab, 10)))
    prompts = [shared + list(map(int, rng.integers(
        5, vocab, int(rng.integers(2, 6))))) for _ in range(5)]
    gens = [4, 16, 7, 12, 9]
    sps = [SamplingParams(temperature=0.8, top_k=0 if i % 2 else 20,
                          top_p=0.95, seed=1000 + i) for i in range(5)]
    return [Request(uid=i, prompt=prompts[i], max_new_tokens=gens[i],
                    sampling=sps[i]) for i in range(5)]


def _greedy(vocab, n=3):
    rng = np.random.default_rng(11)
    return [Request(uid=i, prompt=list(map(int, rng.integers(
        5, vocab, 6 + 9 * i))), max_new_tokens=5) for i in range(n)]


# job name -> (arch name, arch overrides, trace, engine keywords)
JOBS = {
    "llama": ("llama3.2-3b", {"num_kv_heads": 4}, _mixed, ENGINE),
    "llama unfused": ("llama3.2-3b", {"num_kv_heads": 4}, _mixed,
                      dict(ENGINE, fused_decode=False)),
    "starved": ("llama3.2-3b", {"num_kv_heads": 4}, _starved, STARVED),
    "ref sampler": ("llama3.2-3b", {"num_kv_heads": 4}, _mixed,
                    dict(ENGINE, fused_sampling=False)),
    "N=4": ("llama3.2-3b", {"num_kv_heads": 4}, _mixed,
            dict(ENGINE, decode_steps=4)),
    "kv_rep": ("llama3.2-3b", {}, _mixed, ENGINE),
    "moe": ("deepseek-moe-16b", {}, _greedy, ENGINE),
    "hybrid": ("jamba-v0.1-52b", {}, _greedy, ENGINE),
    "vlm": ("qwen2-vl-2b", {}, _greedy, ENGINE),
}
AT_TP = {2: ("llama", "llama unfused", "starved", "ref sampler", "N=4",
             "moe", "hybrid", "vlm"),
         4: ("llama", "kv_rep")}


def _job(name):
    arch_name, kw, trace, engine = JOBS[name]
    t_arch = _archs(arch_name, **kw)[1]
    return {"arch": t_arch, "params": tree.map(lambda t: t.numpy(),
                                               _params(t_arch)),
            "requests": trace(t_arch.vocab_size), "engine": engine}


def _ranks(tp):
    """Every rank's results of the jobs at ``tp`` (one spawn a tp, made
    once for the module)."""
    if tp not in _CACHE:
        jobs = [_job(n) for n in AT_TP[tp]]
        ranks = mesh.spawn(serve.serve_jobs, tp, jobs, 1, backend="gloo",
                           device="cpu", timeout=600)
        _CACHE[tp] = [dict(zip(AT_TP[tp], r)) for r in ranks]
    return _CACHE[tp]


def _port_tp1(name):
    key = ("tp1", name)
    if key not in _CACHE:
        job = _job(name)
        engine = ContinuousEngine(Model(job["arch"], _params(job["arch"])),
                                  **job["engine"])
        res = engine.run(job["requests"])
        _CACHE[key] = ({u: r["tokens"] for u, r in res.items()}, engine)
    return _CACHE[key]


def _jax_tp1(name):
    """JAX's tp=1 engine on the same weights (its engine options as the
    job's, but for the multi-step horizon, which keeps its streams)."""
    key = ("jax", name)
    if key not in _CACHE:
        arch_name, kw, trace, engine = JOBS[name]
        j_arch, t_arch = _archs(arch_name, **kw)
        params = to_jax_layout(_params(t_arch), tf.period_length(t_arch))
        eng = JaxEngine(build_model(j_arch), jax.tree.map(jax.numpy.asarray,
                                                          params),
                        **{k: v for k, v in engine.items()
                           if k != "decode_steps"})
        reqs = [JaxRequest(uid=r.uid, prompt=r.prompt,
                           max_new_tokens=r.max_new_tokens,
                           sampling=JaxSampling(
                               temperature=r.sampling.temperature,
                               top_k=r.sampling.top_k,
                               top_p=r.sampling.top_p, seed=r.sampling.seed))
                for r in trace(t_arch.vocab_size)]
        res = eng.run(reqs)
        _CACHE[key] = ({u: r["tokens"] for u, r in res.items()}, eng)
    return _CACHE[key]


def _check(name, tp):
    ranks = _ranks(tp)
    lead = ranks[0][name]["tokens"]
    assert any(len(t) for t in lead.values())
    for r in ranks[1:]:
        assert r[name]["tokens"] == lead
    assert lead == _port_tp1(name)[0], (name, tp)
    return ranks[0][name]


@pytest.mark.parametrize("name,tp", [("llama", 2), ("llama", 4),
                                     ("llama unfused", 2)])
def test_streams_equal_tp1_and_jax(name, tp):
    got = _check(name, tp)
    assert got["tokens"] == _jax_tp1("llama")[0]
    assert got["counters"]["fused_decode"] == (name == "llama")
    stats = got["tp_stats"]
    assert stats["tp"] == tp and stats["per_device"]["kv_bytes"] > 0
    assert got["counters"]["collective_bytes"] > 0
    assert _port_tp1(name)[1].collective_bytes == 0


def test_starved_pool_preempts_and_copies_at_tp2():
    got = _check("starved", 2)
    assert got["counters"]["prefills"] > 5, "the pool did not preempt"
    assert got["counters"]["cow_copies"] > 0, "no copy-on-write tail"
    assert got["tokens"] == _jax_tp1("starved")[0]


def test_reference_sampler_equals_the_filter_at_tp2():
    assert _check("ref sampler", 2)["tokens"] == _ranks(2)[0]["llama"][
        "tokens"]


def test_four_decode_steps_equal_one_at_tp2():
    got = _check("N=4", 2)
    assert got["tokens"] == _ranks(2)[0]["llama"]["tokens"]
    c = got["counters"]
    assert c["decode_dispatches"] < c["steps"]


def test_kv_head_replication_at_tp4():
    """tp=4 over 2 KV heads: each KV head on 2 ranks."""
    got = _check("kv_rep", 4)
    assert got["tp_stats"]["kv_head_replication"] == 2
    assert got["tokens"] == _jax_tp1("kv_rep")[0]


@pytest.mark.parametrize("name", ["moe", "hybrid", "vlm"])
def test_families_at_tp2_equal_tp1_and_jax(name):
    got = _check(name, 2)
    assert got["tokens"] == _jax_tp1(name)[0]
    if name == "hybrid":
        assert got["tp_stats"]["per_device"]["ssm_state_bytes"] > 0
    if name == "vlm":      # qwen2-vl's one KV head, replicated
        assert got["tp_stats"]["kv_head_replication"] == 2


def test_collective_bytes_and_tp_stats_are_jax_accounting():
    """One fp32 [positions, d_model] ring all-reduce a reduce site (an
    attention output and an MLP / MoE tail a layer; none for mamba):
    2 (tp - 1) / tp of its payload a rank, a decode step at ``num_slots``
    positions and a prefill chunk at ``prefill_chunk``; ``tp_stats()``'s
    keys are JAX's engine's."""
    for tp, name in ((2, "llama"), (4, "llama"), (2, "hybrid"),
                     (2, "moe")):
        got = _ranks(tp)[0][name]
        arch = _job(name)["arch"]
        kinds = tf.layer_kinds(arch)
        psums = sum(1 + (k == "attn") for k in kinds) \
            * (arch.num_layers // len(kinds))
        per = lambda n: psums * n * arch.d_model * 4 * 2 * (tp - 1) // tp
        c = got["counters"]
        assert c["collective_bytes"] == c["steps"] * per(ENGINE["num_slots"]) \
            + c["prefill_chunks"] * per(4 * ENGINE["page_size"])
    jax_stats = _jax_tp1("llama")[1].tp_stats()
    port_stats = _ranks(2)[0]["llama"]["tp_stats"]
    assert set(port_stats) == set(jax_stats)
    assert set(port_stats["per_device"]) == set(jax_stats["per_device"])
    # the pages in use match; the bytes divide by tp
    tp1 = _port_tp1("llama")[1].tp_stats()
    assert tp1 == jax_stats
    assert port_stats["per_device"]["pages_in_use"] == \
        tp1["per_device"]["pages_in_use"]


REJECT = [
    # (arch name, overrides, tp): the check that fails first
    ("llama3.2-3b", {}, 3),                                  # query heads
    ("llama3.2-3b", {"num_heads": 12, "num_kv_heads": 8}, 3),  # KV heads
    ("llama3.2-3b", {"d_ff": 251}, 2),                       # d_ff
    ("deepseek-moe-16b", {}, 8),                             # experts
    ("deepseek-moe-16b", {"moe_expert_ff": 255}, 4),         # shared width
]


@pytest.mark.parametrize("case", REJECT, ids=lambda c: f"{c[0]}-{c[2]}")
def test_rejections_carry_jax_messages_before_any_group(case):
    name, kw, tp = case
    moe_ff = kw.pop("moe_expert_ff", None)
    j_arch, t_arch = _archs(name, **kw)
    if moe_ff:
        j_arch = dataclasses.replace(j_arch, moe=dataclasses.replace(
            j_arch.moe, expert_ff=moe_ff))
        t_arch = dataclasses.replace(t_arch, moe=dataclasses.replace(
            t_arch.moe, expert_ff=moe_ff))
    model = build_model(j_arch)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0)))
    with pytest.raises(AssertionError) as jerr:
        JaxEngine(model, shapes, tp=tp)
    t_model = Model(t_arch, _params(t_arch))
    with pytest.raises(ValueError) as terr:
        ContinuousEngine(t_model, tp=tp)
    assert str(terr.value).startswith(str(jerr.value))
    assert not dist.is_initialized()


def test_split_fused_qkv_is_exact():
    """The split replaces every fused ``wqkv`` / ``bqkv`` and changes no
    bit of a projection (qwen2-vl: fused qkv with biases)."""
    arch = _fp32(smoke_config("qwen2-vl-2b"))
    params = _params(arch)
    gen = torch.Generator().manual_seed(1)
    for blk in params["blocks"]:
        blk["attn"]["bqkv"] = torch.randn(blk["attn"]["bqkv"].shape,
                                          generator=gen)
    split = sh.split_fused_qkv(params, arch)
    names = {k for blk in split["blocks"] for k in blk["attn"]}
    assert "wqkv" not in names and {"wq", "wk", "wv", "bq", "bk",
                                    "bv"} <= names
    x = torch.randn((2, 3, arch.d_model), generator=gen)
    fused, sep = params["blocks"][0]["attn"], split["blocks"][0]["attn"]
    for a, b in zip(tattn.qkv_project(arch, fused, x),
                    tattn.qkv_project(arch, sep, x)):
        assert torch.equal(a, b)


# (arch, overrides, tp): GQA, KV heads replicated (tp > Hkv), experts and
# Megatron-sharded shared experts, replicated mamba mixers, fused qkv with
# biases
SHARDED = [("llama3.2-3b", {"num_kv_heads": 4}, 2),
           ("llama3.2-3b", {"num_kv_heads": 2}, 4),
           ("deepseek-moe-16b", {}, 2), ("jamba-v0.1-52b", {}, 2),
           ("qwen2-vl-2b", {}, 2)]


def _nbytes(tree_):
    """The bytes of the storages behind the leaves, each counted once: a
    shard that is a view would keep its whole leaf alive."""
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tree.leaves(tree_)}.values())


@pytest.mark.parametrize("case", SHARDED, ids=lambda c: f"{c[0]}-tp{c[2]}")
def test_sharded_init_holds_the_whole_models_slices(case):
    """``Model.init(shard=(rank, tp))`` cuts each block as it is made: its
    blocks equal the whole model's ``sharded(rank, tp)`` bit for bit, the
    other leaves too, and a rank holds ``1 / tp`` of the split leaves'
    bytes (times the KV replication) beside whole copies of the rest."""
    name, kw, tp = case
    arch = dataclasses.replace(smoke_config(name), **kw)
    whole = Model.init(arch, torch.Generator().manual_seed(3), device="cpu")
    split = sh.split_fused_qkv(whole.params["blocks"], arch)
    rep = sh.kv_replication(arch, tp)
    if rep > 1:
        split = sh.replicate_kv_heads(split, arch, rep)
    spec = sh.serving_param_spec(split)
    cut = sum(t.numel() * t.element_size() for t, d in zip(
        tree.leaves(split), tree.leaves(spec)) if d is not None)
    whole_bytes = sum(t.numel() * t.element_size()
                      for t in tree.leaves(split))
    for rank in range(tp):
        part = Model.init(arch, torch.Generator().manual_seed(3),
                          device="cpu", shard=(rank, tp))
        assert part.shard == (rank, tp)
        want = whole.sharded(rank, tp)
        for a, b in zip(tree.leaves(part.params), tree.leaves(want.params)):
            assert a.shape == b.shape and torch.equal(a, b)
        assert _nbytes(part.params["blocks"]) * tp == \
            whole_bytes + (tp - 1) * (whole_bytes - cut)


def test_a_rank_serves_only_its_own_shards():
    """The engine's check after its group: a rank's model holds that
    rank's shards, not the whole blocks nor another split's."""
    _, t_arch = _archs("llama3.2-3b", num_kv_heads=4)
    whole = Model(t_arch, _params(t_arch))
    _check_shard(whole.sharded(1, 2), 1, 2)
    for model, held in ((whole, "every weight whole"),
                        (whole.sharded(1, 2), "rank 1 of 2's shards"),
                        (whole.sharded(0, 4), "rank 0 of 4's shards")):
        with pytest.raises(ValueError, match=f"holds {held}"):
            _check_shard(model, 0, 2)
    with pytest.raises(ValueError, match="already holds"):
        whole.sharded(0, 2).sharded(0, 2)


def test_serving_param_spec_layout():
    """The spec table: projections Megatron-sharded, what feeds a
    post-reduce or logits path replicated (embedding, LM head, norms,
    row-parallel biases), routed experts E-major; a fused qkv refused."""
    arch = smoke_config("qwen2-vl-2b")
    params = _params(arch)
    with pytest.raises(ValueError, match="fused"):
        sh.serving_param_spec(params)
    split = sh.split_fused_qkv(params, arch)
    spec = sh.serving_param_spec(split)
    attn, mlp = spec["blocks"][0]["attn"], spec["blocks"][0]["mlp"]
    assert attn["wq"] == 1 and attn["wv"] == 1 and attn["bq"] == 0
    assert attn["wo"] == 0 and attn["bo"] is None
    assert mlp["w1"] == 1 and mlp["w2"] == 0 and mlp["b2"] is None
    assert spec["embed"]["embedding"] is None
    assert spec["final_norm"]["scale"] is None
    assert spec["blocks"][0]["ln1"]["scale"] is None
    moe_arch = smoke_config("deepseek-moe-16b")
    moe_spec = sh.serving_param_spec(sh.split_fused_qkv(
        _params(moe_arch), moe_arch))["blocks"][1]["moe"]
    assert moe_spec["experts"]["w1"] == 0 and moe_spec["experts"]["w2"] == 0
    assert moe_spec["shared"]["w1"] == 1 and moe_spec["shared"]["w2"] == 0
    assert moe_spec["router"] is None
    # rank slices put back together are the leaf
    w = split["blocks"][0]["attn"]["wq"]
    parts = [sh.shard_params({"wq": w}, {"wq": 1}, r, 2)["wq"]
             for r in range(2)]
    assert torch.equal(torch.cat(parts, dim=1), w)


def test_paged_pool_spec_shards_head_axis():
    for name in ("llama3.2-3b", "internlm2-1.8b", "jamba-v0.1-52b"):
        arch = smoke_config(name)
        pools = tf.init_serving_state(arch, 8, 4, 2, torch.float32, "cpu")
        spec = sh.paged_pool_spec(pools)
        for s, p in zip(spec, pools):
            for leaf, dim in s.items():
                if leaf in sh.PAGED_STATE_LEAVES:
                    assert dim == p[leaf].dim() - 2     # the Hkv axis
                else:
                    assert dim is None
    with pytest.raises(KeyError):
        sh.paged_pool_spec([{"cross_k": torch.zeros(1, 2, 3, 4)}])


def test_make_tp_group_needs_cards_for_nccl():
    with pytest.raises(ValueError, match="tp=2 needs 2 devices, found 0"):
        mesh.make_tp_group(2, backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        mesh.make_tp_group(2, backend="mpi")
    assert not dist.is_initialized()


def test_serve_cli_tp2_on_cpu(capsys):
    """``launch.serve --tp 2`` spawns two gloo ranks on the CPU; rank 0
    prints JAX's tp line; the launcher refuses --tp with the static engine
    (JAX's text) and nccl with --device cpu."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--engine",
         "continuous", "--tp", "2", "--device", "cpu", "--smoke", "--batch",
         "2", "--gen-len", "4"], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith(
        "[serve/continuous] tp=2: ")]
    assert len(lines) == 1 and "KV per device" in lines[0] \
        and "head-sharded" in lines[0] and "gloo" in lines[0]
    for argv, msg in ((["--tp", "2"], "--tp requires --engine continuous"),
                      (["--engine", "continuous", "--tp", "2",
                        "--dist-backend", "nccl", "--device", "cpu"],
                       "--dist-backend nccl")):
        with pytest.raises(SystemExit):
            serve.main(["--smoke"] + argv)
        assert msg in capsys.readouterr().err
