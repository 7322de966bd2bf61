"""What the port's multi-rank tests run in each rank (``launch.mesh.spawn``
pickles these by name, so they live in a module that imports neither JAX
nor a test file)."""
import os

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import RunConfig, ShapeConfig
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.convert import to_jax_layout
from repro_torch.models.transformer import period_length
from repro_torch.optim import zero
from repro_torch.parallel import collectives as C
from repro_torch.parallel import pipeline
from repro_torch.parallel.sharding import make_rules
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.steps import build_train_step, zero_collectives


def train_cases(mesh, rank, device, cases, steps):
    """Each case (``arch``, ``run`` keywords, ``params``: the port's tree
    as numpy, ``batches``) trained ``steps`` steps through
    ``build_train_step(run, mesh=mesh)``: its metrics a step, its params
    and its ``m`` / ``v`` / ``master`` shards in JAX's layout, the
    collectives a step by kind, and the counts ``zero_collectives``
    states. Then two steps of the last case through ``train_loop`` with
    the data group (what it logged and kept), and the refusals that
    remain (``_refusals``)."""
    torch.set_num_threads(1)
    out = []
    for case in cases:
        arch = case["arch"]
        run = RunConfig(arch=arch, shape=ShapeConfig(**case["shape"]),
                        **case["run"])
        bundle = build_train_step(run, device="cpu", mesh=mesh)
        state = bundle.init(params=tree.map(torch.from_numpy,
                                            case["params"]))
        metrics, counts = [], []
        for i in range(steps):
            before = dict(C.COUNTS)
            state, met = bundle.fn(state, case["batches"][i])
            counts.append({k: C.COUNTS[k] - before[k] for k in
                           ("all_reduce", "reduce_scatter", "all_gather")})
            metrics.append({k: float(v) for k, v in met.items()})
        out.append({
            "metrics": metrics, "counts": counts,
            "stated": zero_collectives(run, bundle.plan.dp),
            "dp": bundle.plan.dp, "rank": bundle.plan.rank,
            "params": to_jax_layout(state["params"], period_length(arch)),
            "opt": {k: zero.to_jax_layout(state["opt"][k], bundle.plan)
                    for k in ("m", "v", "master") if k in state["opt"]}})
    logs = []
    bundle = build_train_step(run, device="cpu", mesh=mesh)
    looped = train_loop(bundle.fn, bundle.init(0), SyntheticPipeline(DataConfig(
        vocab_size=arch.vocab_size, seq_len=run.shape.seq_len,
        global_batch=run.shape.global_batch)), LoopConfig(
        max_steps=2, log_every=1), log=logs.append,
        group=mesh.get_group("data"))
    return {"cases": out, "refusals": _refusals(run),
            "loop": {"history": len(looped["history"]), "logs": len(logs)}}


def _refusals(run):
    """What a mesh's step still refuses, before any collective: an ssm
    arch on a model axis of 2, and a pod axis of 2 (two ranks either
    way)."""
    from repro_torch.configs import smoke_config
    out = {}
    for name, shape, axes, arch in (
            ("ssm model axis", (1, 2), ("data", "model"),
             smoke_config("mamba2-1.3b")),
            ("pod axis", (2, 1, 1), ("pod", "data", "model"), run.arch)):
        try:
            build_train_step(run.replace(arch=arch), device="cpu",
                             mesh=mesh_lib.make_mesh(shape, axes,
                                                     backend="gloo"))
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def tp_train_cases(mesh, rank, device, cases, steps):
    """Each case (as ``train_cases``, with ``rules``: ``make_rules``
    keywords, and ``fused_blocks``) trained ``steps`` steps on a (data,
    model) mesh: its metrics and collectives a step, the counts
    ``zero_collectives`` states, the rank's coordinates, the sanitized
    specs, and its blocks of the params and of ``m`` / ``v`` / ``master``
    (param-shaped through ``Plan.blocks``), as numpy."""
    torch.set_num_threads(1)
    out = []
    for case in cases:
        os.environ["REPRO_FUSED_BLOCKS"] = "1" if case["fused_blocks"] \
            else "0"
        arch = case["arch"]
        run = RunConfig(arch=arch, shape=ShapeConfig(**case["shape"]),
                        **case["run"])
        bundle = build_train_step(run, device="cpu", mesh=mesh,
                                  rules=make_rules(**case["rules"]))
        state = bundle.init(params=tree.map(torch.from_numpy,
                                            case["params"]))
        metrics, counts = [], []
        for i in range(steps):
            before = dict(C.COUNTS)
            state, met = bundle.fn(state, case["batches"][i])
            counts.append({k: C.COUNTS[k] - before[k] for k in
                           ("all_reduce", "reduce_scatter", "all_gather")})
            metrics.append({k: float(v) for k, v in met.items()})
        ax = bundle.mesh

        def host(t):
            return t.detach().numpy()
        out.append({
            "metrics": metrics, "counts": counts,
            "stated": zero_collectives(run, ax.dp, ax.tp, ax.rules,
                                       bundle.specs),
            "coords": ax.coords, "sizes": ax.sizes, "specs": bundle.specs,
            "params": tree.map(host, state["params"]),
            "opt": {k: tree.map(host, bundle.plan.blocks(
                state["opt"][k], state["params"]))
                for k in ("m", "v", "master") if k in state["opt"]}})
    os.environ.pop("REPRO_FUSED_BLOCKS", None)
    return out


def collective_cases(mesh, rank, device, x, pipe_x, ws, num_micro):
    """JAX's collectives test in a (pod, data) mesh: each rank's gradient
    ``x * (1 + data index + 10 pod index)`` through ``compressed_psum``
    over data and ``hierarchical_psum`` (data inside, pod across); then a
    GPipe pipeline over each pod's data group (a stage a rank, stage s's
    weights ``ws[s]``, ``tanh(x @ w)``) on the batch ``pipe_x``."""
    torch.set_num_threads(1)
    coords = mesh_lib.axis_coords(mesh)
    local = torch.from_numpy(x) * (1.0 + coords["data"]
                                   + 10.0 * coords["pod"])
    data, pod = mesh.get_group("data"), mesh.get_group("pod")
    y, err = C.compressed_psum(local, data)
    h = C.hierarchical_psum(local, data, pod)
    piped = pipeline.pipeline_apply(
        lambda w, t: torch.tanh(t @ w), torch.from_numpy(ws[coords["data"]]),
        torch.from_numpy(pipe_x), num_stages=len(ws), num_micro=num_micro,
        group=data)
    return {"y": y.numpy(), "err": err.numpy(), "h": h.numpy(),
            "pipe": piped.numpy(), "coords": coords,
            "groups": {"data": dist.get_process_group_ranks(data),
                       "pod": dist.get_process_group_ranks(pod)}}
