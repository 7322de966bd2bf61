"""The ZeRO-1 state layout and its data-parallel plan. Counterpart of
``repro.optim.zero`` (``pad_to``, ``flatten_leaf``, ``unflatten_leaf``)
and of the sharding that ``repro.parallel.sharding`` gives the layout
(``opt_flat`` over the data axis), with the collectives that XLA derives
from that sharding written out (``Plan``).

JAX stores each optimizer leaf flat, ``[*rows, padded]`` in fp32: the
leading "row" axes are the ones LAMB takes a trust ratio over (the
scan-stacked layer axis and a MoE leaf's expert axis, ``_layer_axes``),
the rest flattened and padded to a multiple of 256, so that every device
of the data axis holds the same ``padded / dp`` columns of every row.

The port keeps one tensor a layer, so its flat leaves map onto JAX's this
way (``flat_leaves``; "scanned" is a stack JAX scans, more layers than its
period, as ``models.convert.to_jax_layout`` writes it):

- LAMB, a leaf of a scanned decoder stack: layer ``l``'s leaf is row ``l //
  period`` of JAX's ``blocks.layer_<l % period>`` leaf ``[L / period,
  padded]`` (each row padded on its own), an expert leaf ``[E, padded]``
  its ``[L / period, E, padded]`` at that row;
- a leaf of a stack JAX does not scan (one period): JAX's
  ``period_0.layer_<l>`` leaf, ``[1, padded]`` (``[E, padded]`` for
  LAMB's expert leaves);
- a leaf that JAX stacks without a marked layer axis (every scanned stack
  under AdamW, whose leaves are one row; whisper's encoder stack under
  either optimizer): the leaves of every layer at the same place in the
  period, concatenated in layer order and padded once, one flat leaf
  ``[1, padded]``;
- any other leaf: ``[1, padded]`` (``[E, padded]`` for LAMB's experts).

A ``Plan`` is that layout on one rank of a data group: the rank's columns
of every flat leaf (``shard_range``, cut by ``parallel.sharding``'s
``opt_flat`` spec), the packing of the gradient buffer that lets one
``reduce_scatter`` hand each rank its columns of every leaf, and the one
``all_gather`` of the updated parameters. ``to_jax_layout`` writes a
state tree in JAX's flat shapes (the tests' comparison).

On a (data, model) mesh the layout is not JAX's ``opt_flat`` over (data,
model) but one over a rank's blocks with the same bytes a rank: a rank's
plan covers its tensor-parallel block of every leaf. A block the rules
leave whole over the data axis is ZeRO-sharded over the data ranks as
above (its flat columns); an FSDP block (a dim over the data axis) is its
own flat leaf, the rank's slice flattened, held whole (``Plan.local``):
the FSDP gather's reduce-scatter already leaves the rank its slice's
gradient summed over the data axis, and the update is written straight
back into the slice, so such a leaf takes no part in the plan's
reduce-scatter and all-gather. A leaf split over both axes then costs a
rank 1 / (dp tp) of its m, v and master, as JAX's layout does; a leaf
every model rank holds whole costs it 1 / dp.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tree
from ..parallel import collectives
from ..parallel import sharding

PAD_MULTIPLE = 256      # JAX's LambConfig.pad_multiple and the literal 256
                        # of its gradient transform
STACKS = ("blocks", "enc_blocks")


def pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def flatten_leaf(x: torch.Tensor, rows: int, multiple: int) -> torch.Tensor:
    """x [rows * ...] -> a new fp32 tensor [rows, padded]: each row's
    elements, zeros after them (JAX's ``flatten_leaf`` with ``rows`` its
    leading axes' size, 1 where it has none)."""
    flat = x.detach().reshape(rows, -1)
    out = torch.zeros((rows, pad_to(flat.shape[1], multiple)),
                      dtype=torch.float32, device=x.device)
    out[:, :flat.shape[1]] = flat
    return out


def unflatten_leaf(flat: torch.Tensor, shape: Sequence[int],
                   dtype: torch.dtype) -> torch.Tensor:
    """[rows, padded] -> the leaf of ``shape`` in ``dtype`` (JAX's
    ``unflatten_leaf``): each row's first elements, the padding dropped."""
    n = math.prod(shape) // flat.shape[0]
    return flat[:, :n].reshape(tuple(shape)).to(dtype)


def check_dp(dp: int, multiple: int = PAD_MULTIPLE) -> None:
    if dp < 1 or multiple % dp:
        raise ValueError(
            f"dp={dp} does not divide the ZeRO pad multiple {multiple}: "
            f"every flat optimizer leaf is padded to a multiple of "
            f"{multiple} columns, and each of the dp ranks holds an equal "
            f"share of them")


def shard_range(padded: int, rank: int, dp: int) -> Tuple[int, int]:
    """Rank ``rank``'s columns of a flat leaf of ``padded`` columns:
    ``[rank * padded / dp, (rank + 1) * padded / dp)``."""
    if padded % dp or not 0 <= rank < dp:
        raise ValueError(f"rank {rank} of dp={dp} over {padded} columns")
    per = padded // dp
    return rank * per, (rank + 1) * per


def leaf_paths(params, prefix: tuple = ()):
    """(path, leaf) for every leaf of a dict / list tree, in ``tree.leaves``
    order (dict keys sorted); a path holds dict keys and list indices."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from leaf_paths(params[k], prefix + (k,))
    elif isinstance(params, list):
        for i, t in enumerate(params):
            yield from leaf_paths(t, prefix + (i,))
    else:
        yield prefix, params


@dataclasses.dataclass(frozen=True)
class FlatLeaf:
    """One flat optimizer leaf: the parameter leaves (``members``, indices
    in ``tree.leaves`` order, with their ``shapes``) whose elements fill
    its ``rows`` rows of ``n`` elements, padded to ``padded``; ``path`` is
    its place in the state tree (its first member's path, the layer index
    taken within the period where the leaf spans a stack's layers)."""
    path: tuple
    members: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    rows: int
    n: int
    padded: int
    spans: bool = False     # its members are one leaf's layers

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.padded)

    @property
    def ndim(self) -> int:
        return 2


def _unit_key(path: tuple, stacks: Dict[str, int], period: int,
              layer_rows: bool) -> Tuple[tuple, bool]:
    """-> (the flat leaf's path, whether it spans the layers of a stack)."""
    if path and path[0] in stacks:
        per = period if path[0] == "blocks" else 1
        scanned = stacks[path[0]] > per
        if scanned and not (layer_rows and path[0] == "blocks"):
            return (path[0], path[1] % per) + path[2:], True
    return path, False


def flat_leaves(params, *, period: int = 1, layer_rows: bool = True,
                multiple: int = PAD_MULTIPLE) -> Tuple[Any, List[FlatLeaf]]:
    """The flat leaves of ``params`` -> (the state tree's structure, a
    tree whose leaves are the ``FlatLeaf`` records; the records in its
    ``tree.leaves`` order). ``layer_rows`` is LAMB's layout (a row a layer
    of a scanned decoder stack, a row an expert), False AdamW's (one row a
    JAX leaf); ``period`` is the decoder stack's
    (``transformer.period_length``)."""
    stacks = {k: len(params[k]) for k in STACKS
              if isinstance(params.get(k), list)}
    order: List[tuple] = []
    found: Dict[tuple, dict] = {}
    for i, (path, leaf) in enumerate(leaf_paths(params)):
        key, spans = _unit_key(path, stacks, period, layer_rows)
        rows = leaf.shape[0] if (layer_rows and not spans
                                 and "experts" in path[:-1]
                                 and leaf.dim() >= 2) else 1
        if key not in found:
            order.append(key)
            found[key] = {"members": [], "shapes": [], "rows": rows,
                          "spans": spans}
        found[key]["members"].append(i)
        found[key]["shapes"].append(tuple(leaf.shape))
    units = []
    for key in order:
        f = found[key]
        n = sum(math.prod(s) for s in f["shapes"]) // f["rows"]
        units.append(FlatLeaf(key, tuple(f["members"]), tuple(f["shapes"]),
                              f["rows"], n, pad_to(n, multiple), f["spans"]))
    return _tree_of(units), units


def _tree_of(units: List[FlatLeaf]) -> Any:
    """The nested dict / list tree holding each record at its path (list
    indices contiguous from 0)."""
    root: dict = {}
    for u in units:
        node = root
        for k in u.path[:-1]:
            node = node.setdefault(k, {})
        node[u.path[-1]] = u

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [fix(node[i]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}
    return fix(root)


class Plan:
    """The ZeRO-1 layout of a parameter tree on one rank of a data group.

    ``dp`` ranks share the layout, this one is ``rank`` and ``group`` is
    their process group (None for one device); the trainer reads them off
    its mesh's data axis. Every flat leaf is cut by its spec under the
    step's ``rules`` (``sharding.opt_state_pspecs`` for the state,
    ``flat_grad_pspec`` for the gradients; both split the columns over
    ``opt_flat``), so this rank holds columns ``shard_range(padded, rank,
    dp)`` of each of its rows: a contiguous ``[rows, padded / dp]`` shard.
    The gradient buffer is packed as ``[dp, chunk]``, rank r's ``chunk``
    its shards of every leaf one after another (``offsets``), so a
    ``reduce_scatter`` of the buffer
    gives each rank exactly its shards, contiguous; the updated parameters
    travel back the same way, in their own dtype, through one
    ``all_gather`` (``gather_params_``). ``pieces`` says where each
    parameter leaf's columns fall in the rank blocks, so gradients and
    parameters move between their own tensors and the buffers with no
    padded copy.

    On a mesh with a model axis ``params`` is this rank's tree of blocks
    (``parallel.sharding.train_blocks``), and two more things hold:

    - ``local`` names the leaves (their indices in ``tree.leaves`` order)
      that are FSDP slices, a dim split over the data axis. Such a leaf's
      flat leaf is its own slice, flattened and padded, whole on this rank
      (``[rows, padded]``): its gradient reaches the rank already summed
      over the data axis (the FSDP gather's reduce-scatter), its update is
      written straight into the slice, and neither takes part in the
      plan's collectives. The ``[dp, zchunk]`` packed buffer holds the
      other flat leaves; ``lchunk`` elements after it hold the local ones.
      A rank's optimizer bytes are then 1 / (dp tp) of a leaf split over
      both axes, as JAX's ``opt_flat`` gives, and 1 / dp of a replicated
      one.
    - ``split`` says how the model axis splits each leaf: 0 not at all
      (every model rank holds it whole), 1 within its rows (the ranks hold
      other columns of the same trust-ratio rows), 2 across them (an
      expert-parallel leaf: the ranks hold other experts, other rows).
      ``norm_group`` is the group over which squared norms are summed (the
      whole mesh) and ``model_group`` the model axis's. ``count`` weighs
      each flat leaf's squared norms before the sum over the mesh: 1 for a
      split leaf, and for a leaf every model rank holds whole, 1 on model
      rank 0 and 0 on the others, so it is counted once; ``row_sum``
      marks the flat leaves whose per-row partial norms are summed over
      the model axis too (split 1).

    On a mesh with a pod axis (``pod_group``) the layout stays within a
    pod, as JAX's ``opt_state_pspecs`` keeps ZeRO off the pod axis: every
    pod holds the same shards, and ``reduce_scatter`` sums the rank's
    reduced chunk over the pod axis too (one ``all_reduce``, the middle
    step of ``collectives.hierarchical_psum``), so that each pod updates
    the same shards with the whole batch's gradients."""

    def __init__(self, params, *, period: int = 1, layer_rows: bool = True,
                 dp: int = 1, rank: int = 0, group=None,
                 multiple: int = PAD_MULTIPLE, local: Sequence[int] = (),
                 split: Optional[Sequence[int]] = None, norm_group=None,
                 model_group=None, mrank: int = 0, rules=None,
                 pod_group=None):
        self.struct, self.units = flat_leaves(
            params, period=period, layer_rows=layer_rows, multiple=multiple)
        self.period = period
        self.stacks = {k: len(params[k]) for k in STACKS
                       if isinstance(params.get(k), list)}
        check_dp(dp, multiple)
        self.dp, self.rank, self.group = dp, rank, group
        self.pod_group = pod_group
        local = set(local)
        self.local = []
        for u in self.units:
            inside = {i in local for i in u.members}
            if len(inside) > 1:
                raise ValueError(f"{u.path}: a flat leaf whose members are "
                                 "FSDP slices and whole leaves")
            self.local.append(inside.pop())
        sizes, coords = {"data": dp}, {"data": rank}
        specs = tree.leaves(sharding.opt_state_pspecs(
            {"m": self.struct}, None, True, rules)["m"])
        for u, spec, lo in zip(self.units, specs, self.local):
            if lo:
                continue
            got = sharding.local_slice(spec, u.shape, sizes, coords)
            want = (slice(0, u.rows),
                    slice(*shard_range(u.padded, rank, dp)))
            if got != want or want != sharding.local_slice(
                    sharding.flat_grad_pspec(u, rules=rules), u.shape,
                    sizes, coords):
                raise ValueError(f"{u.path}: the state's slice {got} and "
                                 "the gradient's must be the columns "
                                 f"{want[1]} of every row")
        self.offsets, z, l_ = [], 0, 0
        for u, lo in zip(self.units, self.local):
            if lo:
                self.offsets.append(l_)
                l_ += u.rows * u.padded
            else:
                self.offsets.append(z)
                z += u.rows * (u.padded // dp)
        self.zchunk, self.lchunk = z, l_
        self.chunk = z + l_         # elements of this rank's shards
        self.pieces = [_pieces(u, 1 if lo else dp)
                       for u, lo in zip(self.units, self.local)]
        self.norm_group = group if norm_group is None else norm_group
        self.model_group = model_group
        self.count = self.row_sum = None
        self._weights: Dict[tuple, torch.Tensor] = {}
        if split is not None and model_group is not None:
            self.count = [float(mrank == 0 or split[u.members[0]] > 0)
                          for u in self.units]
            self.row_sum = [float(split[u.members[0]] == 1)
                            for u in self.units]

    def weights(self, device, sizes: Optional[Sequence[int]] = None,
                of: str = "count") -> Optional[torch.Tensor]:
        """``count`` (or ``row_sum``) as an fp32 tensor on ``device``, one
        entry a flat leaf, or each repeated over its ``sizes`` entries;
        made once (a captured step reads the same tensor), None without a
        model axis."""
        values = getattr(self, of)
        if values is None:
            return None
        key = (of, str(device), None if sizes is None else tuple(sizes))
        if key not in self._weights:
            t = torch.tensor(values, dtype=torch.float32)
            if sizes is not None:
                t = torch.repeat_interleave(t, torch.tensor(list(sizes)))
            self._weights[key] = t.to(device)
        return self._weights[key]

    # ------------------------------------------------------------ layout --
    @property
    def flat_elements(self) -> int:
        """The elements of every flat leaf this rank's plan spans, padding
        included: dp x zchunk + lchunk."""
        return self.dp * self.zchunk + self.lchunk

    def cols(self, i: int) -> int:
        """Columns of flat leaf ``i``'s shard on this rank."""
        u = self.units[i]
        return u.padded if self.local[i] else u.padded // self.dp

    def state(self, values: List[Any]) -> Any:
        """A state tree (``struct``'s shape) holding ``values``, one a flat
        leaf in ``units`` order."""
        return tree.unflatten(self.struct, list(values))

    def zeros(self, device) -> Any:
        """A state tree of fp32 zeros, this rank's shard of every flat
        leaf (LAMB's and AdamW's ``m`` and ``v`` at init)."""
        return self.state([torch.zeros(
            (u.rows, self.cols(i)), dtype=torch.float32, device=device)
            for i, u in enumerate(self.units)])

    def shards(self, params) -> List[torch.Tensor]:
        """This rank's fp32 shard of every flat leaf of ``params`` (a tree
        of the parameters' structure), each a tensor of its own, zero in
        the padding."""
        leaves = tree.leaves(params)
        out = []
        for i, (u, pieces) in enumerate(zip(self.units, self.pieces)):
            shard = torch.zeros((u.rows, self.cols(i)), dtype=torch.float32,
                                device=leaves[u.members[0]].device)
            mine = 0 if self.local[i] else self.rank
            for j, cuts in zip(u.members, pieces):
                x = leaves[j].detach().reshape(u.rows, -1)
                for s, e, b, lo, hi in cuts:
                    if b == mine:
                        shard[:, lo:hi] = x[:, s:e]
            out.append(shard)
        return out

    def grad_shards(self, grads) -> List[torch.Tensor]:
        """Gradients as an optimizer takes them: the trainer's list of
        this rank's flat shards as it is, gradients shaped like the params
        flattened (one device only: a rank's own gradients are not its
        share of the group's sum)."""
        if isinstance(grads, list):
            return grads
        if self.dp > 1:
            raise ValueError("with a data group the optimizer takes the "
                             "rank's reduced flat gradient shards, not its "
                             "own gradients")
        return self.shards(grads)

    def views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """The shard views of a ``[chunk]`` buffer packed in this rank's
        order (the packed shards, then the local ones)."""
        return [self._rank_region(buf, i)[0]
                for i in range(len(self.units))]

    def _rank_region(self, buf: torch.Tensor, i: int) -> torch.Tensor:
        """Flat leaf ``i``'s ``[1, rows, cols]`` region of a rank layout
        buffer ``[chunk]``."""
        u, o = self.units[i], self.offsets[i]
        if self.local[i]:
            o += self.zchunk
        n = u.rows * self.cols(i)
        return buf[o:o + n].view(1, u.rows, self.cols(i))

    def _packed_region(self, acc: torch.Tensor, i: int) -> torch.Tensor:
        """Flat leaf ``i``'s ``[blocks, rows, cols]`` region of a packed
        buffer ``[dp * zchunk + lchunk]`` (one block a rank; one for a
        local leaf)."""
        u, o, pd = self.units[i], self.offsets[i], self.cols(i)
        if self.local[i]:
            o += self.dp * self.zchunk
            return acc[o:o + u.rows * pd].view(1, u.rows, pd)
        rows2d = acc[:self.dp * self.zchunk].view(self.dp, self.zchunk)
        return rows2d[:, o:o + u.rows * pd].view(self.dp, u.rows, pd)

    # -------------------------------------------------------- gradients --
    def accumulator(self, device) -> torch.Tensor:
        """A zeroed fp32 gradient buffer ``[dp * zchunk + lchunk]``, rank
        r's shards of every packed flat leaf in its r-th ``zchunk``, the
        local flat leaves after them."""
        return torch.zeros(self.dp * self.zchunk + self.lchunk,
                           dtype=torch.float32, device=device)

    def accumulate_(self, acc: torch.Tensor, grads: Sequence[torch.Tensor],
                    num_micro: int = 1) -> None:
        """Add one micro-batch's gradients (the parameters' leaves, in
        ``tree.leaves`` order) into ``acc`` in the flat layout, in fp32,
        divided by ``num_micro`` as JAX's accumulation divides them (not
        at 1): each leaf's columns straight into their rank blocks."""
        for i, (u, pieces) in enumerate(zip(self.units, self.pieces)):
            dst = self._packed_region(acc, i)
            for j, cuts in zip(u.members, pieces):
                g = grads[j].reshape(u.rows, -1)
                if num_micro > 1:
                    g = g.float() / num_micro
                for s, e, b, lo, hi in cuts:
                    dst[b, :, lo:hi].add_(g[:, s:e])

    def reduce_scatter(self, acc: torch.Tensor) -> torch.Tensor:
        """Sum the packed part of ``acc`` over the data group and keep
        this rank's ``zchunk`` of it, the local part after it: one
        ``reduce_scatter`` (``acc`` itself at dp=1); then, with a pod
        group, the whole chunk summed over the pods (one ``all_reduce``)."""
        if self.dp == 1:
            out = acc
        else:
            out = torch.empty(self.chunk, dtype=acc.dtype,
                              device=acc.device)
            collectives.reduce_scatter(out[:self.zchunk],
                                       acc[:self.dp * self.zchunk],
                                       self.group)
            out[self.zchunk:].copy_(acc[self.dp * self.zchunk:])
        if self.pod_group is not None:
            collectives.all_reduce(out, self.pod_group)
        return out

    def blocks(self, flat_tree, like) -> Any:
        """A state tree of this rank's flat shards (``struct``'s shape:
        ``m``, ``v`` or ``master``) as fp32 tensors shaped like the
        parameters ``like`` (the rank's blocks), through the same
        ``all_gather`` as ``gather_params_`` (a collective: every rank of
        the data group calls it)."""
        out = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), like)
        self.gather_params_(out, tree.leaves(flat_tree))
        return out

    # --------------------------------------------------------- parameters --
    @torch.no_grad()
    def gather_params_(self, params, shards: Sequence[torch.Tensor]) -> None:
        """Write the updated fp32 ``shards`` (one a flat leaf, this rank's
        columns) into every rank's parameters, in place: each shard cast
        to the parameters' dtype, packed, one ``all_gather`` of the packed
        part over the data group, and every rank copies each leaf's rows
        out of it (so all ranks hold the same bits); a local leaf's shard
        is its own slice, copied in place."""
        leaves = tree.leaves(params)
        dtype = leaves[0].dtype
        buf = torch.empty(self.chunk, dtype=dtype, device=leaves[0].device)
        for v, s in zip(self.views(buf), shards):
            v.copy_(s)
        if self.dp == 1 or not self.zchunk:
            full = buf
        else:
            full = torch.empty(self.dp * self.zchunk + self.lchunk,
                               dtype=dtype, device=buf.device)
            collectives.all_gather(full[:self.dp * self.zchunk],
                                   buf[:self.zchunk], self.group)
            full[self.dp * self.zchunk:].copy_(buf[self.zchunk:])
        for i, (u, pieces) in enumerate(zip(self.units, self.pieces)):
            src = self._packed_region(full, i)
            for j, cuts in zip(u.members, pieces):
                x = leaves[j].view(u.rows, -1)
                for s, e, b, lo, hi in cuts:
                    x[:, s:e].copy_(src[b, :, lo:hi])


def _pieces(u: FlatLeaf, dp: int) -> List[List[Tuple[int, ...]]]:
    """For each member of ``u`` the pieces of its columns: ``(s, e, b, lo,
    hi)``, its columns ``[s, e)`` of each row are columns ``[lo, hi)`` of
    rank ``b``'s shard (the members fill a row one after another, and the
    row is cut at every ``shard_range`` boundary)."""
    bounds = [shard_range(u.padded, b, dp) for b in range(dp)]
    out, at = [], 0
    for shape in u.shapes:
        n = math.prod(shape) // u.rows
        cuts = []
        for b, (lo, hi) in enumerate(bounds):
            a, z = max(at, lo), min(at + n, hi)
            if a < z:
                cuts.append((a - at, z - at, b, a - lo, z - lo))
        out.append(cuts)
        at += n
    return out


def jax_path(path: tuple, stacks: Dict[str, int],
             period: int) -> Tuple[tuple, Optional[int]]:
    """The JAX leaf that a port leaf at ``path`` belongs to -> (its path in
    JAX's tree, the row of its scan-stacked layer axis, or None where JAX
    does not scan the stack), as ``models.convert.to_jax_layout`` lays the
    stacks out."""
    if path and path[0] in stacks:
        per = period if path[0] == "blocks" else 1
        if stacks[path[0]] > per:
            return ((path[0], f"layer_{path[1] % per}") + path[2:],
                    path[1] // per)
        return (path[0], "period_0", f"layer_{path[1]}") + path[2:], None
    return path, None


def to_jax_layout(flat_tree, plan: Plan) -> Dict[str, Any]:
    """A tree of this rank's flat shards (``plan.struct``'s shape: the
    optimizer's ``m``, ``v`` or ``master``) -> JAX's flat state tree as
    float32 numpy, each leaf JAX's shape with its last axis this rank's
    columns: ``[1 or E, cols]`` for a leaf of one row block, ``[L /
    period, (E,) cols]`` for LAMB's rows of a scanned decoder stack."""
    stacked: Dict[tuple, Dict[int, np.ndarray]] = {}
    out: Dict[str, Any] = {}

    def put(path, value):
        node = out
        for k in path[:-1]:
            node = node.setdefault(str(k), {})
        node[str(path[-1])] = value

    for u, x in zip(plan.units, tree.leaves(flat_tree)):
        x = x.detach().float().cpu().numpy()
        path, row = jax_path(u.path, plan.stacks, plan.period)
        if row is None or u.spans:
            put(path, x)
        else:
            stacked.setdefault(path, {})[row] = x if u.rows > 1 else x[0]
    for path, rows in stacked.items():
        put(path, np.stack([rows[i] for i in range(len(rows))]))
    return out
