"""Weight bridge between the JAX package's ``Model.init`` pytree (leaves as
numpy arrays) and the port's weight dict (see ``models.model``), both ways.

The JAX stack keeps its layers as stacked periods: either one dict whose
leaves carry a leading ``[num_layers]`` axis (``blocks.layer_0.*``, the
scanned layout) or ``blocks.period_<z>.layer_0.*`` dicts. Both become the
port's list of per-layer dicts. The fused ``wqkv`` projection is kept
fused. Nothing here imports JAX: callers hand in ``np.asarray`` leaves.
``to_jax_layout`` goes back, for any tree in the port's layout (params,
or the optimizer's ``m``, ``v`` and ``master``), so tests can hold the two
trainers' states side by side.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ArchConfig, torch_dtype
from .layers import Params


def _tensors(tree: Any, device, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v, device, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, copy=True)).to(device)
    return t.to(dtype) if t.is_floating_point() else t


def _unstack(blocks: Dict[str, Any], num_layers: int) -> List[Dict[str, Any]]:
    if any(k.startswith("period_") for k in blocks):
        return [blocks[f"period_{z}"]["layer_0"] for z in range(num_layers)]
    layer = blocks["layer_0"]

    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]
    return [take(layer, i) for i in range(num_layers)]


def from_jax_params(arch: ArchConfig, params: Dict[str, Any],
                    device="cuda") -> Params:
    """Convert a dense-family JAX param tree (numpy leaves) to the port's
    weights on ``device``, floats cast to the config's dtype (as the JAX
    engine casts its params). Every leaf keeps its JAX name, biases,
    ``pos`` and BERT's ``mlm`` head included."""
    device = resolve_device(device)
    dtype = torch_dtype(arch.dtype)
    if arch.family != "dense":
        raise NotImplementedError(f"family {arch.family!r} is not ported")
    out: Params = {
        k: _tensors(v, device, dtype) for k, v in params.items()
        if k != "blocks"}
    out["blocks"] = [_tensors(b, device, dtype)
                     for b in _unstack(params["blocks"], arch.num_layers)]
    return out


def _numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


def to_jax_layout(params: Params) -> Dict[str, Any]:
    """The port's tree -> the JAX package's, as float32 numpy: the per-layer
    ``blocks`` list becomes ``blocks.layer_0`` with a leading ``[L]`` axis
    on every leaf (the scanned layout of ``repro.models.transformer``)."""
    out = {k: _numpy(v) for k, v in params.items() if k != "blocks"}
    layers = [_numpy(b) for b in params["blocks"]]

    def stack(*trees):
        if isinstance(trees[0], dict):
            return {k: stack(*(t[k] for t in trees)) for k in trees[0]}
        return np.stack(trees)
    out["blocks"] = {"layer_0": stack(*layers)}
    return out
