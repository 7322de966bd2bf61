"""Weight bridge: the JAX package's ``Model.init`` pytree, with its leaves
as numpy arrays, -> the port's weight dict (see ``models.model``).

The JAX stack keeps its layers as stacked periods: either one dict whose
leaves carry a leading ``[num_layers]`` axis (``blocks.layer_0.*``, the
scanned layout) or ``blocks.period_<z>.layer_0.*`` dicts. Both become the
port's list of per-layer dicts. The fused ``wqkv`` projection is kept
fused. Nothing here imports JAX: callers hand in ``np.asarray`` leaves.
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
    engine casts its params)."""
    device = resolve_device(device)
    dtype = torch_dtype(arch.dtype)
    if arch.family != "dense":
        raise NotImplementedError(f"family {arch.family!r} is not ported")
    out: Params = {
        "embed": _tensors(params["embed"], device, dtype),
        "blocks": [_tensors(b, device, dtype)
                   for b in _unstack(params["blocks"], arch.num_layers)],
        "final_norm": _tensors(params["final_norm"], device, dtype),
    }
    if "out" in params:
        out["out"] = _tensors(params["out"], device, dtype)
    return out
