"""The serving engine's tensor-parallel layout (Megatron): counterpart of the
serving part of ``repro.parallel.sharding`` (``_SERVING_TP_RULES``,
``_SERVING_EXPERT_RULES``, ``serving_param_pspecs``,
``PAGED_STATE_LEAVES``, ``paged_pool_pspecs``). JAX names a mesh axis for
each dim of a leaf; the port's mesh is one axis of ``tp`` ranks, so a
leaf's spec is the one dim that is split across the ranks, or None where
every rank holds the whole leaf. ``shard_params`` cuts each rank's
contiguous slices; ``serving_shards`` takes a block list from the whole
model's layout (fused qkv, ``Hkv`` KV heads) to a rank's. A rank keeps only
its shards: ``models.model.Model.init(..., shard=(rank, tp))`` cuts each
block as soon as it is made.

The training rules are here too, the counterpart of the training half of
``repro.parallel.sharding``: ``make_rules`` (JAX's logical-axis table and
its options; ``TRAIN_RULES`` its defaults), ``_PARAM_RULES`` /
``_EXPERT_RULES`` / ``param_pspecs`` (a spec for every leaf of every
arch, by name), ``_sanitize`` / ``sanitize_spec`` / ``sanitize_tree`` (a
dim an axis does not divide stays whole), ``batch_pspecs``,
``opt_state_pspecs`` and ``flat_grad_pspec``. A training spec has one
entry a dim, the mesh axis (or tuple of axes) that dim is split over, or
None, as JAX's ``PartitionSpec``; ``local_slice`` cuts a rank's block of
a dim split over several axes in JAX's order (the first axis major), and
``train_block_index`` / ``train_blocks`` cut a rank's block of every
leaf, the fused ``wqkv`` by heads (its q, k and v columns). The trainer's
ZeRO plan (``optim.zero.Plan``) cuts every flat optimizer leaf and the
step every micro-batch with them.

Replicated: the embedding, the LM head, the norms, the router, mamba
mixers and the biases of the row-parallel projections (``bo``, ``b2``),
which are added once, after the reduce. So every rank computes the same
logits and draws the same tokens, with no collective.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

# leaf name -> the split dim counted from the end: -1 column-parallel (the
# output features, head-major, so rank i's block holds its heads), -2
# row-parallel (partial sums, reduced across the ranks)
_SERVING_TP_RULES: Dict[str, int] = {
    "wq": -1, "wk": -1, "wv": -1,
    "bq": -1, "bk": -1, "bv": -1,
    "wo": -2,
    "w1": -1, "w3": -1,
    "b1": -1, "b3": -1,
    "w2": -2,
}

# under an "experts" parent the matrices carry a leading [E, ...] expert
# dim: each rank owns E / tp whole experts ("shared" experts are a dense
# MLP and take the rules above)
_SERVING_EXPERT_RULES: Dict[str, int] = {"w1": -3, "w3": -3, "w2": -3}

# leaf names of the serving decode state: the per-page KV pools [P, page,
# Hkv, Dh] and the per-slot mamba state
PAGED_STATE_LEAVES = ("k", "v")
SLOT_STATE_LEAVES = ("conv", "state")


def map_with_path(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any,
                  path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of a nested dict / list tree;
    ``path`` holds the dict keys and list indices (as strings) above the
    leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _map_attn(tree, fn):
    """``tree`` (dicts and the per-layer block lists) with every
    self-attention's parameter dict ``attn`` replaced by ``fn(attn)``."""
    if isinstance(tree, list):
        return [_map_attn(t, fn) for t in tree]
    if not isinstance(tree, dict):
        return tree
    return {k: fn(dict(v)) if k == "attn" and isinstance(v, dict)
            else _map_attn(v, fn) for k, v in tree.items()}


def split_fused_qkv(params, arch):
    """Every attention block's fused ``wqkv`` / ``bqkv`` replaced by the
    equivalent ``wq / wk / wv`` (``bq / bk / bv``) column slices, as JAX's
    ``_split_fused_qkv``: head sharding needs each projection's columns
    head-major and contiguous, and a slice of the fused feature dim would
    mix q and kv columns. Exact: each output column's product is
    unchanged."""
    cuts = [arch.q_dim, arch.kv_dim, arch.kv_dim]

    def split(p):
        for fused, names in (("wqkv", ("wq", "wk", "wv")),
                             ("bqkv", ("bq", "bk", "bv"))):
            if fused in p:
                p.update(zip(names, torch.split(p.pop(fused), cuts, dim=-1)))
        return p
    return _map_attn(params, split)


def replicate_kv_heads(params, arch, rep: int):
    """Every K/V projection's head blocks repeated ``rep`` times, head-major
    (new head j holds old head j // rep), so that the column-parallel slice
    of ``tp > Hkv`` ranks gives each rank one whole KV head: rank i's query
    heads all group onto old KV head i // rep, the block it receives. The
    GQA math is unchanged, at rep x the KV memory (the engine's
    ``tp_stats``)."""
    hd = arch.resolved_head_dim

    def rep_heads(p):
        for name in ("wk", "wv", "bk", "bv"):
            if name in p:
                w = p[name]
                r = torch.repeat_interleave(
                    w.reshape(w.shape[:-1] + (w.shape[-1] // hd, hd)), rep,
                    dim=-2)
                p[name] = r.reshape(w.shape[:-1] + (w.shape[-1] * rep,))
        return p
    return _map_attn(params, rep_heads)


def kv_replication(arch, tp: int) -> int:
    """The copies of each KV head a ``tp``-way split needs: ``tp // Hkv``
    where ``tp > Hkv`` (each rank then holds one whole head), else 1 (the
    engine's checks refuse a ``tp`` that neither divides nor is divided by
    ``Hkv``)."""
    hkv = arch.num_kv_heads
    return tp // hkv if hkv and hkv % tp else 1


def serving_shards(blocks, arch, rank: int, tp: int):
    """Rank ``rank``'s serving layout of a list of blocks in the whole
    model's layout: fused qkv split, KV heads replicated where ``tp >
    Hkv``, then each split leaf's slice (``shard_params``); the rest of a
    block (norms, row-parallel biases, mamba mixers, the router) is
    returned as it is."""
    blocks = split_fused_qkv(blocks, arch)
    rep = kv_replication(arch, tp)
    if rep > 1:
        blocks = replicate_kv_heads(blocks, arch, rep)
    return shard_params(blocks, serving_param_spec(blocks), rank, tp)


def serving_param_spec(params: Any) -> Any:
    """For every leaf the dim that the ranks split (non-negative), or None
    where it is replicated. A fused ``wqkv`` / ``bqkv`` raises: a slice of
    the fused feature dim would mix q and kv columns (the engine splits it
    first, ``split_fused_qkv``)."""
    def leaf_spec(path, leaf):
        name = path[-1]
        if name in ("wqkv", "bqkv"):
            raise ValueError("fused qkv cannot be head-sharded; split into "
                             f"wq/wk/wv first ({'/'.join(path)})")
        if "experts" in path[:-1] and name in _SERVING_EXPERT_RULES:
            dim = _SERVING_EXPERT_RULES[name]
        else:
            dim = _SERVING_TP_RULES.get(name)
        if dim is None:
            return None
        if leaf.dim() < -dim:
            raise ValueError(f"{'/'.join(path)} {tuple(leaf.shape)} has no "
                             f"dim {dim}")
        return leaf.dim() + dim
    return map_with_path(leaf_spec, params)


def paged_pool_spec(pools: Any) -> Any:
    """For every leaf of the engine's decode state the dim the ranks split:
    a KV pool's head axis (``PAGED_STATE_LEAVES``, always ndim - 2), so
    each rank holds the same pages, its heads of each; None for mamba's
    slot state (``SLOT_STATE_LEAVES``: the mixer is replicated). Page ids
    stay global, so one host allocator and page table drive every rank."""
    def leaf_spec(path, leaf):
        name = path[-1]
        if name in PAGED_STATE_LEAVES:
            return leaf.dim() - 2
        if name in SLOT_STATE_LEAVES:
            return None
        raise KeyError(f"no serving-state sharding rule for "
                       f"{'/'.join(path)}")
    return map_with_path(leaf_spec, pools)


def shard_params(params: Any, spec: Any, rank: int, tp: int) -> Any:
    """Rank ``rank``'s parameters: each split leaf's ``rank``-th of ``tp``
    contiguous slices along its spec's dim (a copy in a storage of its
    own: a leading-dim slice of a contiguous leaf is already contiguous,
    and as a view it would keep the whole leaf alive), every other leaf as
    it is (the same tensor)."""
    def take(leaf: torch.Tensor, dim: Optional[int]):
        if dim is None:
            return leaf
        n = leaf.shape[dim]
        if n % tp:
            raise ValueError(f"dim {dim} of {tuple(leaf.shape)} does not "
                             f"split into {tp}")
        return leaf.narrow(dim, rank * (n // tp), n // tp).clone(
            memory_format=torch.contiguous_format)

    def walk(tree, sp):
        if isinstance(tree, dict):
            return {k: walk(v, sp[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, s) for v, s in zip(tree, sp)]
        return take(tree, sp)
    return walk(params, spec)


# ------------------------------------------------------------------ training --
Spec = Tuple[Any, ...]      # a mesh axis, a tuple of axes or None a dim
Rules = Dict[str, Any]


def make_rules(multi_pod: bool = False, *, seq_parallel: bool = True,
               fsdp: bool = True, expert_parallel: bool = True,
               overrides: Sequence[Tuple[str, Optional[str]]] = ()
               ) -> Rules:
    """JAX's logical-axis table: logical name -> the mesh axis (or axes)
    it is split over, None where it is replicated. ``seq_parallel`` puts
    the residual stream's sequence on the model axis, ``fsdp`` one big dim
    of every weight matrix on the data axis, ``expert_parallel`` the
    experts on the model axis (else each expert's FF dim, ``expert_mlp``);
    ``overrides`` are (name, axis) pairs applied last."""
    rules: Rules = {
        "batch": ("pod", "data") if multi_pod else ("data",),
        "seq": "model" if seq_parallel else None,
        "cache_seq": "model",
        "embed": None,
        "q_heads": "model",
        "kv": None,
        "vocab": "model",
        "fsdp": "data" if fsdp else None,
        "tensor": "model",
        "experts": "model" if expert_parallel else None,
        "expert_mlp": None if expert_parallel else "model",
        "opt_flat": ("data", "model"),      # ZeRO-1 optimizer states
        "none": None,
    }
    for name, axis in overrides:
        rules[name] = axis
    return rules


TRAIN_RULES: Rules = make_rules()


def spec(*logical: Optional[str], rules: Optional[Rules] = None) -> Spec:
    """Logical names (None: replicated) -> a spec through ``rules``
    (default ``TRAIN_RULES``)."""
    rules = TRAIN_RULES if rules is None else rules
    return tuple(rules.get(name) if name else None for name in logical)


# leaf name -> logical axes of its trailing dims (JAX's table): column-
# parallel weights put their output features on "tensor", row-parallel
# their input features; the other big dim streams over "fsdp"
_PARAM_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "embedding": ("tensor", "fsdp"),     # [V, D] vocab-sharded
    "pos_embedding": (None, None),
    "head": ("fsdp", "tensor"),          # [D, V]
    "wqkv": ("fsdp", "tensor"),
    "wq": ("fsdp", "tensor"),
    "wk": ("fsdp", "tensor"),
    "wv": ("fsdp", "tensor"),
    "wo": ("tensor", "fsdp"),
    "bqkv": ("tensor",),
    "bq": ("tensor",),
    "bk": ("tensor",),
    "bv": ("tensor",),
    "bo": (None,),
    "w1": ("fsdp", "tensor"),
    "w3": ("fsdp", "tensor"),
    "w2": ("tensor", "fsdp"),
    "b1": ("tensor",),
    "b3": ("tensor",),
    "b2": (None,),
    "router": ("fsdp", None),
    "in_proj": ("fsdp", "tensor"),
    "out_proj": ("tensor", "fsdp"),
    "conv": (None, "tensor"),
    "A_log": (None,),
    "D": (None,),
    "dt_bias": (None,),
    "norm_scale": (None,),
    "scale": (None,),
    "bias": (None,),
    "dense": ("fsdp", None),
}

# under an "experts" parent: [E, D, F] / [E, F, D], E over the experts'
# axis, D streamed over "fsdp", each expert's FF dim whole
_EXPERT_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "w1": ("experts", "fsdp", None),
    "w3": ("experts", "fsdp", None),
    "w2": ("experts", None, "fsdp"),
}


def _leaf_spec(path: Tuple[str, ...], leaf, rules: Optional[Rules] = None
               ) -> Spec:
    name = path[-1]
    in_experts = "experts" in path[:-1]
    table = _EXPERT_RULES if (in_experts and name in _EXPERT_RULES) \
        else _PARAM_RULES
    if name not in table:
        raise KeyError(f"no sharding rule for parameter {'/'.join(path)}")
    logical = table[name]
    pad = leaf.ndim - len(logical)
    if pad < 0:
        raise ValueError(f"{'/'.join(path)} {tuple(leaf.shape)} has fewer "
                         f"dims than its rule {logical}")
    return spec(*([None] * pad + list(logical)), rules=rules)


def param_pspecs(params: Any, rules: Optional[Rules] = None) -> Any:
    """The spec tree of a parameter tree (JAX's ``param_pspecs``): each
    leaf's spec by its name (``_PARAM_RULES``; ``_EXPERT_RULES`` under
    ``experts``), leading dims beyond the rule replicated."""
    return map_with_path(lambda path, leaf: _leaf_spec(path, leaf, rules),
                         params)


def _sanitize(sp: Spec, shape: Sequence[int],
              axis_sizes: Mapping[str, int]) -> Spec:
    """Each dim keeps the axes of its entry that still divide it, in
    order (JAX's ``_sanitize``): a dim an axis does not divide stays
    whole over that axis."""
    out = []
    for i, axes in enumerate(tuple(sp) + (None,) * (len(shape) - len(sp))):
        if axes is None:
            out.append(None)
            continue
        kept, size = [], 1
        for a in _axes(axes):
            s = axis_sizes[a]
            if shape[i] % (size * s) == 0:
                kept.append(a)
                size *= s
        out.append(tuple(kept) if len(kept) > 1
                   else (kept[0] if kept else None))
    return tuple(out)


def sanitize_spec(sp: Spec, shape: Sequence[int],
                  axis_sizes: Optional[Mapping[str, int]]) -> Spec:
    """``sp`` without the mesh axes that do not divide their dims of
    ``shape``; with no mesh (``axis_sizes`` None) ``sp`` as it is."""
    if axis_sizes is None:
        return sp
    return _sanitize(sp, shape, axis_sizes)


def sanitize_tree(specs: Any, structs: Any,
                  axis_sizes: Optional[Mapping[str, int]]) -> Any:
    """``sanitize_spec`` over a spec tree and the matching tree of
    leaves (anything with a ``shape``)."""
    if isinstance(specs, dict):
        return {k: sanitize_tree(v, structs[k], axis_sizes)
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [sanitize_tree(v, t, axis_sizes)
                for v, t in zip(specs, structs)]
    return sanitize_spec(specs, structs.shape, axis_sizes)


def batch_pspecs(batch: Mapping[str, Any],
                 rules: Optional[Rules] = None) -> Dict[str, Spec]:
    """Input batches: the batch dim over the data axis, the rest whole;
    ``mrope_positions`` [3, B, S] splits its dim 1."""
    out = {}
    for name, v in batch.items():
        if name == "mrope_positions":
            out[name] = spec(None, "batch", None, rules=rules)
        elif v.ndim >= 1:
            out[name] = spec("batch", *([None] * (v.ndim - 1)), rules=rules)
        else:
            out[name] = ()
    return out


def _flat_spec(path: Tuple, leaf, rules: Optional[Rules] = None) -> Spec:
    rules = TRAIN_RULES if rules is None else rules
    if "experts" in path and leaf.ndim == 2:    # [E, flat]
        return (rules["experts"], "data")
    return (None,) * (leaf.ndim - 1) + (rules.get("opt_flat",
                                                  ("data", "model")),)


def opt_state_pspecs(state: Mapping[str, Any], params_specs,
                     zero1: bool, rules: Optional[Rules] = None
                     ) -> Dict[str, Any]:
    """Optimizer-state specs (JAX's). ``zero1``: every flat leaf's
    columns over ``opt_flat`` (an expert leaf ``[E, padded]``: E over the
    experts' axis, the columns over data); else
    ``m`` / ``v`` mirror ``params_specs``. ``step`` is replicated."""
    out = {}
    for k, v in state.items():
        if k == "step":
            out[k] = ()
        elif zero1:
            out[k] = map_with_path(
                lambda path, leaf: _flat_spec(path, leaf, rules), v)
        else:
            out[k] = params_specs
    return out


def flat_grad_pspec(leaf, rules: Optional[Rules] = None) -> Spec:
    """The spec of a flat-layout gradient-accumulation leaf (the port's
    are 2-D): the columns over ``opt_flat``."""
    rules = TRAIN_RULES if rules is None else rules
    return (None,) * (leaf.ndim - 1) + (rules.get("opt_flat",
                                                  ("data", "model")),)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def local_slice(sp: Spec, shape: Sequence[int],
                axis_sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` under ``sp``: a dim split
    over axes (a, b) has ``size(a) * size(b)`` equal blocks, and the rank
    at coordinates (i, j) holds block ``i * size(b) + j``. An axis the
    mesh lacks has size 1; a dim that does not split evenly raises."""
    out = []
    for i, n in enumerate(shape):
        entry = sp[i] if i < len(sp) else None
        parts, index = 1, 0
        for a in _axes(entry):
            s = axis_sizes.get(a, 1)
            parts, index = parts * s, index * s + coords.get(a, 0)
        if n % parts:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"into {parts} over {entry}")
        out.append(slice(index * (n // parts), (index + 1) * (n // parts)))
    return tuple(out)


def split_dims(sp: Spec, axis: str) -> Tuple[int, ...]:
    """The dims of a (sanitized) spec split over ``axis``."""
    return tuple(i for i, e in enumerate(sp) if axis in _axes(e))


def leaf_items(tree: Any, path: Tuple[str, ...] = ()) -> list:
    """(path, leaf) of every leaf of a dict / list tree in the order
    ``repro_torch.tree.leaves`` walks it (dict keys sorted); a path holds
    the dict keys and list indices as strings. A tuple is a leaf (a
    spec)."""
    if isinstance(tree, dict):
        return [it for k in sorted(tree)
                for it in leaf_items(tree[k], path + (str(k),))]
    if isinstance(tree, list):
        return [it for i, v in enumerate(tree)
                for it in leaf_items(v, path + (str(i),))]
    return [(path, tree)]


def _fused_qkv_columns(arch, n: int, tp: int, r: int) -> torch.Tensor:
    """The columns of a fused ``wqkv`` / ``bqkv`` of ``n`` columns (q,
    then k, then v) that model rank ``r`` of ``tp`` holds: its share of
    each of the three, so that its block is its query heads' q columns
    and their K/V heads' k and v columns (where ``tp`` > Hkv, its
    ``kv_dim / tp`` columns of the one KV head its query heads read)."""
    q, kv = arch.q_dim, arch.kv_dim
    if n != q + 2 * kv or q % tp or kv % tp:
        raise ValueError(f"fused qkv of {n} columns (q {q}, kv {kv}) does "
                         f"not split into {tp} ranks' heads")
    parts = [torch.arange(off + r * w // tp, off + (r + 1) * w // tp)
             for off, w in ((0, q), (q, kv), (q + kv, kv))]
    return torch.cat(parts)


def train_block_index(path: Tuple[str, ...], shape: Sequence[int],
                      sp: Spec, arch, axis_sizes: Mapping[str, int],
                      coords: Mapping[str, int]) -> Tuple[Any, ...]:
    """The index of this rank's block of a whole training leaf under its
    sanitized spec ``sp``: ``local_slice``'s contiguous blocks, except the
    model-split dim of a fused ``wqkv`` / ``bqkv``, indexed by the rank's
    q, k and v columns (``_fused_qkv_columns``)."""
    index = list(local_slice(sp, shape, axis_sizes, coords))
    if path[-1] in ("wqkv", "bqkv"):
        d = len(shape) - 1
        if "model" in _axes(sp[d]):
            if _axes(sp[d]) != ("model",):
                raise NotImplementedError(f"{'/'.join(path)}: fused qkv "
                                          f"columns split over {sp[d]}")
            index[d] = _fused_qkv_columns(arch, shape[d],
                                          axis_sizes["model"],
                                          coords["model"])
    return tuple(index)


def train_blocks(params: Any, specs: Any, arch,
                 axis_sizes: Mapping[str, int],
                 coords: Mapping[str, int]) -> Any:
    """This rank's block of every whole leaf of ``params`` under the
    sanitized ``specs`` (each a copy in a storage of its own)."""
    def cut(path, leaf):
        sp = _at(specs, path)
        idx = train_block_index(path, leaf.shape, sp, arch, axis_sizes,
                                coords)
        return leaf[idx].clone(memory_format=torch.contiguous_format)
    return map_with_path(cut, params)


def _at(tree: Any, path: Tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree
