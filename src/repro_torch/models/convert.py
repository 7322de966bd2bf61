"""Weight bridge between the JAX package's ``Model.init`` pytree (leaves as
numpy arrays) and the port's weight dict (see ``models.model``), both ways.

The JAX stack keeps its layers as stacked periods: either one dict whose
leaves carry a leading ``[num_periods]`` axis (``blocks.layer_<i>.*``, the
scanned layout) or ``blocks.period_<z>.layer_<i>.*`` dicts. Both become the
port's list of per-layer dicts, periods flattened in order (period z's
layer i is layer ``z * period + i``: jamba's 32 layers are 4 periods of
8). The fused ``wqkv`` projection is kept fused; a mamba block keeps its
``mamba`` leaves (``in_proj``, ``conv``, ``A_log``, ``D``, ``dt_bias``,
``norm_scale``, ``out_proj``) and a MoE block its ``moe`` leaves
(``router``, ``experts.{w1, w3, w2}``, ``shared.{w1, w3, w2}``) by name.
Whisper's encoder stack ``enc_blocks`` is stacked the same way and becomes
a list too; a decoder block keeps ``ln_x`` and ``xattn`` (separate ``wq``,
``wk``, ``wv``, ``wo`` and their biases) by name. Nothing here imports
JAX: callers hand in ``np.asarray`` leaves.
``to_jax_layout`` goes back, for any tree in the port's layout (params,
or the optimizer's ``m``, ``v`` and ``master``), so tests can hold the two
trainers' states side by side; ``state_to_jax`` and ``load_state_`` do the
same for a whole trainer state in its own dtypes, the layout a checkpoint
holds (``repro_torch.checkpoint``); ``caches_from_jax`` unstacks the JAX
static engine's caches the same way (whisper's ``cross_k`` / ``cross_v``
with a layer's ``k`` / ``v``), so tests compare cache contents.

A training mesh's ranks each hold a block of every leaf
(``parallel.sharding.train_blocks`` cuts them from a whole tree);
``assemble`` puts the ranks' blocks (their params, or their optimizer
state made param-shaped by ``optim.zero.Plan.blocks``) back together, for
the tests. ``state_to_jax`` refuses such a state: JAX's
launcher never writes one.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ArchConfig, torch_dtype
from ..tree import leaves
from .layers import Params


def _tensors(tree: Any, device, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v, device, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, copy=True)).to(device)
    return t.to(dtype) if t.is_floating_point() else t


def _period_layers(period: Dict[str, Any]) -> List[Any]:
    return [period[f"layer_{i}"] for i in range(len(period))]


def _unstack(blocks: Dict[str, Any]) -> List[Dict[str, Any]]:
    if any(k.startswith("period_") for k in blocks):
        periods = [blocks[f"period_{z}"] for z in range(len(blocks))]
    else:
        def take(tree, z):
            if isinstance(tree, dict):
                return {k: take(v, z) for k, v in tree.items()}
            return tree[z]

        nper = leaves(blocks)[0].shape[0]
        periods = [take(blocks, z) for z in range(nper)]
    return [layer for per in periods for layer in _period_layers(per)]


def from_jax_params(arch: ArchConfig, params: Dict[str, Any],
                    device="cuda") -> Params:
    """Convert a JAX param tree of any family (numpy leaves) to the port's
    weights on ``device``, floats cast to the config's dtype (as the JAX
    serve casts its params, mamba's fp32 ``A_log``, ``D`` and ``dt_bias``
    and the MoE's fp32 router included). Every leaf keeps its JAX name,
    biases, ``pos``, BERT's ``mlm`` head and whisper's ``enc_final_norm``
    included."""
    device = resolve_device(device)
    dtype = torch_dtype(arch.dtype)
    stacks = {"blocks": arch.num_layers, "enc_blocks": arch.enc_layers}
    out: Params = {
        k: _tensors(v, device, dtype) for k, v in params.items()
        if k not in stacks}
    for name, n in stacks.items():
        if name not in params:
            continue
        out[name] = [_tensors(b, device, dtype)
                     for b in _unstack(params[name])]
        if len(out[name]) != n:
            raise ValueError(f"{len(out[name])} layers in the tree's "
                             f"{name}, {n} in {arch.name}")
    return out


def caches_from_jax(arch: ArchConfig, caches: Dict[str, Any],
                    device="cuda") -> List[Params]:
    """The JAX static engine's caches (``Model.init_caches`` /
    ``prefill`` / ``decode_step``, numpy leaves, stacked like ``blocks``)
    -> the port's per-layer list: ``{k, v}`` of an attention layer in the
    config's dtype, ``{conv, state}`` of a mamba layer with the SSD state
    in fp32, as ``transformer.init_caches`` makes them."""
    device = resolve_device(device)
    dtype = torch_dtype(arch.dtype)
    out = []
    for layer in _unstack(caches):
        out.append({k: torch.from_numpy(np.array(v, copy=True)).to(
            device=device, dtype=torch.float32 if k == "state" else dtype)
            for k, v in layer.items()})
    if len(out) != arch.num_layers:
        raise ValueError(f"{len(out)} layer caches in the tree, "
                         f"{arch.num_layers} in {arch.name}")
    return out


def _numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


def _host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


STACKS = ("blocks", "enc_blocks")


def to_jax_layout(params: Params, period: int = 1,
                  keep_dtype: bool = False) -> Dict[str, Any]:
    """The port's tree -> the JAX package's, for a stack whose period is
    ``period`` layers (``transformer.period_length``), as float32 numpy
    or, with ``keep_dtype``, as CPU tensors in their own dtypes (copies,
    the form a checkpoint saves): ``blocks.layer_<i>`` with a leading
    ``[L / period]`` axis on every leaf (the scanned layout of
    ``repro.models.transformer``), or, for a stack of one period (which
    JAX does not scan), ``blocks.period_0.layer_<i>``. Whisper's
    ``enc_blocks`` (period 1) go back the same way."""
    stacks = {"blocks": period, "enc_blocks": 1}
    conv = _host if keep_dtype else _numpy
    out = {k: conv(v) for k, v in params.items() if k not in stacks}

    def stack(*trees):
        if isinstance(trees[0], dict):
            return {k: stack(*(t[k] for t in trees)) for k in trees[0]}
        return torch.stack(trees) if keep_dtype else np.stack(trees)
    for name, per in stacks.items():
        if name not in params:
            continue
        layers = [conv(b) for b in params[name]]
        if len(layers) == per:
            out[name] = {"period_0": {f"layer_{i}": layers[i]
                                      for i in range(per)}}
        else:
            out[name] = {f"layer_{i}": stack(*layers[i::per])
                         for i in range(per)}
    return out


def assemble(blocks: List[Any], coords: List[Dict[str, int]], specs: Any,
             arch: ArchConfig, axis_sizes: Dict[str, int]) -> Any:
    """Whole leaves from every mesh rank's blocks: ``blocks[i]`` (a tree of
    tensors or numpy arrays, rank i's blocks) is written into each whole
    leaf at its index (``sharding.train_block_index``); ranks that hold
    the same block write it in turn (the tests hold them equal on their
    own). Returns a tree of CPU tensors."""
    from ..parallel import sharding
    out: Dict[tuple, torch.Tensor] = {}
    items = [sharding.leaf_items(b) for b in blocks]
    for j, (path, sp) in enumerate(sharding.leaf_items(specs)):
        first = torch.as_tensor(np.asarray(items[0][j][1]))
        shape = []
        for d, n in enumerate(first.shape):
            parts = 1
            for a in sharding._axes(sp[d] if d < len(sp) else None):
                parts *= axis_sizes.get(a, 1)
            shape.append(n * parts)
        whole = torch.zeros(shape, dtype=first.dtype)
        for rank_items, c in zip(items, coords):
            idx = sharding.train_block_index(path, shape, sp, arch,
                                             axis_sizes, c)
            whole[idx] = torch.as_tensor(np.asarray(rank_items[j][1]))
        out[path] = whole

    def build(tree, path=()):
        if isinstance(tree, dict):
            return {k: build(v, path + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v, path + (str(i),)) for i, v in enumerate(tree)]
        return out[path]
    return build(specs)


def state_to_jax(state: Any, period: int = 1) -> Any:
    """A trainer state (or any tree of dicts) -> JAX's layout as CPU
    tensors in their own dtypes: every dict holding a ``blocks`` or
    ``enc_blocks`` list (the params, the optimizer's ``m``, ``v`` and
    ``master``) through ``to_jax_layout``, every other leaf copied. A
    ZeRO-1 state (``m`` in the flat layout) raises: JAX's trainer never
    checkpoints one (its launcher passes ``zero1=False``), nor does it
    write a training mesh's blocks."""
    if isinstance(state, dict) and "params" in state \
            and "m" in state.get("opt", {}):
        shapes = [[t.shape for t in leaves(x)]
                  for x in (state["params"], state["opt"]["m"])]
        if shapes[0] != shapes[1]:
            raise NotImplementedError(
                "a ZeRO-1 optimizer state (flat shards) is not "
                "checkpointed: JAX's trainer never writes one (its "
                "launcher passes zero1=False)")
    if isinstance(state, dict):
        if any(isinstance(state.get(k), list) for k in STACKS):
            return to_jax_layout(state, period, keep_dtype=True)
        return {k: state_to_jax(v, period) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    return torch.as_tensor(np.array(state, copy=True))


def load_state_(state: Any, tree: Any) -> None:
    """Copy ``tree`` (JAX's layout, tensors or numpy arrays) into the
    port's ``state`` in place (``copy_``: every tensor keeps its address,
    so a captured step stays valid). Shapes and dtypes must match; the
    stacks are unstacked as ``from_jax_params`` unstacks them."""
    if isinstance(state, dict):
        if set(state) != set(tree):
            raise ValueError(f"keys {sorted(state)} against the "
                             f"checkpoint's {sorted(tree)}")
        for k, v in state.items():
            src = tree[k]
            if k in STACKS and isinstance(v, list):
                src = _unstack(src)
            load_state_(v, src)
    elif isinstance(state, list):
        if len(state) != len(tree):
            raise ValueError(f"{len(state)} layers against the "
                             f"checkpoint's {len(tree)}")
        for v, src in zip(state, tree):
            load_state_(v, src)
    else:
        src = torch.as_tensor(tree)
        if src.shape != state.shape or src.dtype != state.dtype:
            raise ValueError(f"checkpoint leaf {src.dtype} "
                             f"{tuple(src.shape)} against the state's "
                             f"{state.dtype} {tuple(state.shape)}")
        with torch.no_grad():
            state.copy_(src)
