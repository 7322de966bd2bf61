"""Process groups and meshes. Counterpart of ``repro.launch.mesh``
(``make_tp_mesh``, ``make_mesh``, ``make_host_mesh``): JAX builds a mesh
over the devices of one process; the port runs one process a rank,
PyTorch's idiom, and the ranks meet in a ``torch.distributed`` process
group. ``make_tp_group`` is the serving engine's group of ``tp`` ranks;
``make_mesh`` lays the world's ranks out on a grid of named axes
(``torch.distributed.device_mesh``), one process group a line of each
axis, as the trainer's data axis needs. ``spawn`` starts the ranks.

The backend is always the caller's: ``"nccl"`` puts each rank on a card of
its own (``cuda:<local rank>``), ``"gloo"`` runs the collectives on the
host, over CPU tensors (the tests) or over the tensors of a card the ranks
share. Nothing here picks or changes a backend or a device.
"""
from __future__ import annotations

import math
import os
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def free_port() -> int:
    """A free TCP port on localhost for a group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_tp_group(tp: int, *, backend: str, device=None,
                  rank: Optional[int] = None,
                  init_method: Optional[str] = None
                  ) -> Tuple[object, int, torch.device]:
    """Join or create the group of ``tp`` ranks -> ``(group, rank,
    device)``.

    - If ``torch.distributed`` is initialized already, its world is the
      group and must hold ``tp`` ranks on ``backend``.
    - Else the group is created: with ``rank`` and ``init_method`` (e.g.
      ``tcp://localhost:<port>``) as a launcher's own spawn gives them, or
      from the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
      ``MASTER_ADDR``, ``MASTER_PORT``).

    ``backend="nccl"`` needs ``tp`` cards on the host (it raises, as JAX's
    mesh does, with "tp=N needs N devices, found M") and gives rank r the
    card ``cuda:<LOCAL_RANK or r>``; ``device`` must be None or that card.
    ``backend="gloo"`` gives every rank ``device`` (default the CPU)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}: {backend!r}")
    if backend == "nccl":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < tp:
            raise ValueError(f"tp={tp} needs {tp} devices, found {n} (the "
                             "nccl backend puts each rank on a card of its "
                             "own; gloo lets ranks share one)")
    if not dist.is_initialized():
        if rank is None:
            if "RANK" not in os.environ:
                raise ValueError(
                    f"tp={tp}: no process group; launch the ranks with "
                    "torchrun, or pass rank and init_method")
            rank = int(os.environ["RANK"])
            world = int(os.environ.get("WORLD_SIZE", tp))
            if world != tp:
                raise ValueError(f"tp={tp} but WORLD_SIZE is {world}")
            init_method = init_method or "env://"
        elif init_method is None:
            raise ValueError("make_tp_group: rank given without init_method")
        kw = {}
        if backend == "nccl":
            # the rank's card first, so the communicator is made on it
            card = _card(rank, device)
            torch.cuda.set_device(card)
            kw["device_id"] = card
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=tp, **kw)
    if dist.get_world_size() != tp:
        raise ValueError(f"tp={tp} but the process group has "
                         f"{dist.get_world_size()} ranks")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not the {backend!r} asked for")
    rank = dist.get_rank()
    if backend == "nccl":
        card = _card(rank, device)
        torch.cuda.set_device(card)
        return dist.group.WORLD, rank, card
    return dist.group.WORLD, rank, torch.device(device or "cpu")


def _card(rank: int, device) -> torch.device:
    """A nccl rank's card: ``cuda:<LOCAL_RANK or rank>``; ``device``, if
    given, must be it."""
    card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    if device is not None and torch.device(device) != card:
        raise ValueError(f"rank {rank} runs on {card} under nccl, not "
                         f"{device}")
    return card


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, backend: str,
              device=None, rank: Optional[int] = None,
              init_method: Optional[str] = None):
    """A mesh of ``prod(shape)`` ranks with the named ``axes`` (JAX's
    ``make_mesh``): a ``DeviceMesh`` whose ``get_group(axis)`` is this
    rank's line along ``axis``, a process group on ``backend``. The world
    group is joined or made as ``make_tp_group`` does (``rank``,
    ``init_method`` or ``torchrun``'s environment); rank r sits at the
    row-major position r of ``shape``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} against axes {axes}")
    make_tp_group(math.prod(shape), backend=backend, device=device,
                  rank=rank, init_method=init_method)
    return init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                            mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, **kw):
    """A (data, model) mesh of gloo ranks on the CPU, for tests (JAX's
    ``make_host_mesh``)."""
    return make_mesh((data, model), ("data", "model"), backend="gloo", **kw)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> its size (an empty dict for no mesh: one device)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_coords(mesh) -> Dict[str, int]:
    """Axis name -> this rank's index along it."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _rank_main(fn, tp, rank, init_method, backend, device, mesh, args,
               results):
    """A spawned rank: join the group (and lay out the mesh), run ``fn``,
    report to the parent."""
    try:
        group, rank, dev = make_tp_group(tp, backend=backend, device=device,
                                         rank=rank, init_method=init_method)
        if mesh is not None:
            group = make_mesh(*mesh, backend=backend, device=device)
        results.put((rank, True, fn(group, rank, dev, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable[..., Any], tp: int, *args: Any, backend: str,
          device=None, mesh: Optional[Tuple[Sequence[int], Sequence[str]]]
          = None, timeout: float = 3600.0) -> List[Any]:
    """Run ``fn(group, rank, device, *args)`` in ``tp`` new processes (the
    ``spawn`` start method), each a rank of a new world of ``tp`` ranks
    made by ``make_tp_group`` over ``tcp://127.0.0.1:<free port>``; with
    ``mesh=(shape, axes)`` (``prod(shape) == tp``) ``group`` is the rank's
    ``make_mesh(shape, axes)`` instead of the world. Returns every rank's
    return value (picklable) in rank order. A rank that raises stops the
    others (they may wait in a collective) and the error is raised here
    with its traceback. ``fn`` and ``args`` must pickle."""
    if mesh is not None and math.prod(mesh[0]) != tp:
        raise ValueError(f"a mesh of shape {tuple(mesh[0])} for {tp} ranks")
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, tp, r, init, backend, device, mesh,
                               args, results), daemon=True)
             for r in range(tp)]
    for p in procs:
        p.start()
    got, failed = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(got) < tp and failed is None:
            while not results.empty():
                rank, ok, value = results.get()
                if ok:
                    got[rank] = value
                elif failed is None:
                    failed = f"rank {rank} failed:\n{value}"
            if len(got) == tp or failed is not None:
                break
            dead = [p for p in procs if p.exitcode not in (None, 0)]
            if dead and results.empty():
                failed = (f"rank {procs.index(dead[0])} exited with code "
                          f"{dead[0].exitcode}")
            elif time.monotonic() > deadline:
                failed = f"the {tp} ranks did not finish in {timeout} s"
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if failed is not None and p.is_alive():
                p.terminate()
        for p in procs:
            # a rank that has reported may still hang in its group's
            # teardown (seen under nccl: a rank's shutdown waits on the
            # store that rank 0 closed when it exited): its result is in,
            # so it is stopped
            p.join(timeout=15)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    if failed is not None:
        raise RuntimeError(failed)
    return [got[r] for r in range(tp)]
