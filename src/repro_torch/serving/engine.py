"""ContinuousEngine of the port: continuous batching over a paged KV cache
with chunked prefill, prefix caching (copy-on-write tail pages),
forced-replay preemption and per-request sampling. Counterpart of
``repro.serving.engine.ContinuousEngine`` in its single-device, one step
per dispatch configuration; the scheduler decisions, the counters and the
per-request results are the same, so the two engines emit identical token
streams for the same weights and requests.

The stack is driven through the per-layer decode-state protocol
(``models.transformer.init_serving_state``): attention layers keep paged
KV pools, mamba layers a pooled, constant-size state per slot. The dense,
moe, vlm (qwen2-vl: M-RoPE with the text-only positions, as JAX's engine
passes no ``mrope_positions``), attention-free ssm (mamba2) and hybrid
(jamba) families are served; encdec (whisper) is static-engine only and
refused with JAX's message.
Slot recycling resets a mamba row at the next sequence's first chunk, and
preemption stays forced replay: re-prefilling the victim's context
recomputes the state. Prefix caching shares pages, which recurrent state is
not decomposable into, so an SSM-bearing arch gates it off with a reason on
the engine (``prefix_cache_off_reason``) and in every request's result.

Each decode step of a dense model runs the whole ``num_slots`` batch:
embed -> per layer [RMSNorm -> QKV + RoPE -> K/V written into pages ->
paged decode attention kernel -> o-proj -> residual add + RMSNorm ->
SwiGLU -> residual add] -> final norm -> LM head -> token selection.
Slots that are empty or mid-prefill carry seq_len 0 and write to the null
page. Prefill runs one chunk of one sequence per iteration through the
paged prefill attention kernel; only a final chunk pays the LM head. A
mamba2 layer is [RMSNorm -> in_proj -> causal conv + SiLU -> SSD step
(decode) or chunked SSD scan (prefill) -> gated RMSNorm kernel ->
out_proj -> residual add]; an idle slot's state row is left as it was.
A MoE layer's tail (``models.moe``) routes each slot's token on its own
(one capacity slot an expert at decode), and each prefill chunk drops at
the full prompt's capacity, computed on the host as JAX's engine does.

Fused decode (``fused_decode``, on by default as in the JAX engine; the
environment rule is ``serving.sampling.fused_decode_enabled``) folds each
layer's ln2 residual add + norm into one ``decode_residual_norm`` kernel
(not mamba2's blocks, which have no ln2 site) and runs the final norm, the
LM head and the selection as one ``head_tokens`` kernel that reads the
tied embedding [V, D], or an untied head [D, V], in place and returns
tokens, never logits. Unfused, the
head materializes fp32 logits and selects with a greedy argmax or the
sampler (filter kernel for filtered requests, then the draw kernel). On the CPU the two paths emit bitwise
identical streams; on the card they may fork on near-tied logits. A
post-norm stack and an MLM-transform head serve unfused, with
``fused_decode_off_reason`` saying why (JAX's strings). Encoder-only
(bidirectional) archs are refused, and so
are attention archs whose positions or window the paged path cannot apply
(learned positions, a sliding window), with JAX's messages.

Options, as in JAX: ``sanitize`` (None = ``REPRO_SANITIZE``) runs the
runtime sanitizer (``analysis.sanitize``): the host invariants after every
request completion, and finite probes computed on the device beside every
decode step's and prefill chunk's tokens, read back in the same copy as
those tokens (a non-final chunk's probe rides the next copy), so the
sanitizer adds no synchronisation. ``fused_sampling`` (None =
``REPRO_FUSED_SAMPLING``) picks the filter kernel or the sort-based oracle;
both give the same tokens. ``decode_steps=N > 1`` runs up to N decode
iterations per host dispatch (``models.transformer.paged_decode_loop_step``
over the static buffers of ``serving.graphs.DecodeLoop``: on the card the
iteration is a CUDA graph, replayed as many times as the host can predict,
with the loop's exit bits and an EOS computed on the card) and makes one
host synchronisation per dispatch; streams equal N=1's. ``decode_dispatches``
and ``decode_exits`` count the dispatches and why they came back, as JAX's.
At N=1 the decode step is the eager single step.

PyTorch runs eagerly, so there is no compile cache: variants are plain
Python branches on the ``sampled`` / ``filtered`` flags, keyed as JAX keys
its jit cache; ``trace_stats()`` counts the variants the traffic exercised
and their traces (a graph capture on the card, a first use otherwise).

Tensor parallelism (``tp > 1``) runs one engine a rank, each in its own
process, over a ``torch.distributed`` group (``group``; see
``launch.mesh.make_tp_group``), as JAX runs one engine under ``shard_map``
over a ("model",) mesh. The engine checks the arch against ``tp`` first, in
JAX's order and with JAX's messages, before it touches a group. The model
it is given holds only the rank's Megatron shards (``Model.init(...,
shard=(rank, tp))`` or ``model.sharded(rank, tp)``, through
``parallel.sharding.serving_shards``: a fused ``wqkv`` split, each KV head
repeated ``tp // Hkv`` times where ``tp > Hkv``, each split leaf sliced),
so no rank holds a whole block: attention on its ``Hq /
tp`` query and ``Hkv * kv_rep / tp`` KV heads, a page pool holding those
heads of every page (page ids global, so each rank's host allocator, prefix
index and scheduler make the same decisions), the MLP column- then
row-parallel, MoE experts ``E / tp`` a rank, mamba mixers replicated.
Each attention output and MLP or MoE tail ends in one fp32
``all_reduce`` (JAX's ``psum`` sites). The embedding, the norms and the
LM head stay replicated: every rank runs the whole head (the fused
``head_tokens`` kernel or the unfused head and sampler) on the replicated
hidden state, so every rank's tokens are the tokens tp=1 selects from the
same x, with no collective. The scheduler's clock is rank 0's: each read
of it is broadcast (``_clock``), so every rank admits, preempts and
sleeps at the same iterations, and ``token_times`` are rank 0's.
``collective_bytes`` and ``tp_stats()`` are JAX's accounting.

Not ported yet (raises ``NotImplementedError``): fused decode with a
logit softcap.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..analysis.sanitize import (check_engine, check_finite_probe,
                                 sanitize_enabled)
from ..kernels.fused_lm_head import ops as head_ops
from ..models import ssm as ssm_lib
from ..models import transformer as tf
from ..models.layers import apply_norm, pad_vocab
from ..models.model import Model
from ..models.moe import capacity_per_row
from ..parallel import sharding as shardlib
from .graphs import DecodeLoop
from .kv_cache import pages_needed
from .sampling import (fused_decode_enabled, fused_sampling_enabled,
                       sample_tokens)
from .scheduler import Request, Scheduler, SequenceState

SERVABLE_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")


def prefix_cache_off_reason(arch) -> Optional[str]:
    """Why the engine gates prefix caching off for ``arch``, or None.
    Prefix caching shares pages; a mamba mixer's recurrent state is not
    page-decomposable, so SSM-bearing archs gate it off."""
    if "mamba" not in tf.layer_kinds(arch):
        return None
    return ("prefix cache unsupported for SSM-bearing archs "
            f"({arch.name}): recurrent state is not page-decomposable")


def _not_ported(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"({slice_})")


def _check_tp(arch, tp: int, has_attn: bool) -> int:
    """JAX's checks of ``tp`` against the arch, in JAX's order and with its
    messages (``ValueError`` where JAX asserts), made before any process
    group is touched -> ``kv_rep``, the copies of each KV head (``tp //
    Hkv`` where ``tp > Hkv``, else 1)."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1: {tp}")
    if tp == 1:
        return 1
    if arch.moe is not None:
        if arch.moe.num_experts % tp:
            raise ValueError(f"tp={tp} must divide the expert count "
                             f"({arch.moe.num_experts}) — expert-parallel "
                             "layout")
        if arch.moe.num_shared_experts:
            shared_ff = (arch.moe.expert_ff or arch.d_ff) \
                * arch.moe.num_shared_experts
            if shared_ff % tp:
                raise ValueError(f"{(shared_ff, tp)}: tp must divide the "
                                 "shared experts' width")
    if has_attn:
        if arch.num_heads % tp:
            raise ValueError(f"tp={tp} must divide query heads "
                             f"({arch.num_heads}) — head-sharded layout")
        hkv = arch.num_kv_heads
        if hkv % tp and tp % hkv:
            raise ValueError(f"tp={tp} must divide the KV heads ({hkv}) or "
                             "be a multiple of them (KV-head replication)")
    if arch.d_ff and arch.d_ff % tp:
        raise ValueError(f"{(arch.d_ff, tp)}: tp must divide d_ff")
    return shardlib.kv_replication(arch, tp) if has_attn else 1


def _tp_group(group, tp: int):
    """The engine's group of ``tp`` ranks -> (group, this rank): ``group``,
    or the default group where ``torch.distributed`` is initialized; none
    is made here (``launch.mesh.make_tp_group`` makes one)."""
    if group is None:
        if not dist.is_initialized():
            raise ValueError(
                f"tp={tp} needs {tp} ranks, found 1: run one engine a rank "
                f"in a process group of {tp} (launch.mesh.make_tp_group) "
                "and pass it as group")
        group = dist.group.WORLD
    n = dist.get_world_size(group)
    if n != tp:
        raise ValueError(f"tp={tp} needs {tp} ranks, found {n}")
    return group, dist.get_rank(group)


def _check_shard(model: Model, rank: int, tp: int) -> None:
    """A rank of ``tp`` serves a model that holds its own shards only
    (``Model.shard``), never the whole blocks."""
    if model.shard == (rank, tp):
        return
    held = "every weight whole" if model.shard is None else \
        "rank %d of %d's shards" % model.shard
    raise ValueError(f"tp={tp}: rank {rank} serves its own shards of the "
                     f"weights, and the model holds {held}; build them with "
                     f"Model.init(..., shard=({rank}, {tp})) or "
                     f"model.sharded({rank}, {tp})")


class ContinuousEngine:
    def __init__(self, model: Model, *, num_slots: int = 8,
                 num_pages: int = 256, page_size: int = 16,
                 max_seq_len: int = 512, prefix_cache: bool = True,
                 prefill_chunk: Optional[int] = None, tp: int = 1,
                 group=None, sanitize: Optional[bool] = None,
                 fused_sampling: Optional[bool] = None,
                 decode_steps: int = 1,
                 fused_decode: Optional[bool] = None):
        arch = model.arch
        if arch.family not in SERVABLE_FAMILIES:
            raise ValueError(f"continuous engine serves families "
                             f"{SERVABLE_FAMILIES}; {arch.name} is "
                             f"{arch.family!r}")
        if arch.bidirectional:
            raise ValueError("encoder-only archs have no decode step")
        kinds = tf.layer_kinds(arch)
        self.has_attn = "attn" in kinds
        self.has_ssm = "mamba" in kinds
        if self.has_attn:
            if arch.pos_emb not in ("rope", "mrope", "none"):
                raise ValueError("paged decode re-derives positions from "
                                 "seq_lens (rope/mrope/none only)")
            if arch.window != 0:
                raise ValueError("paged decode-attention has no "
                                 "sliding-window masking yet")
        if decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1: {decode_steps}")
        self.kv_rep = _check_tp(arch, tp, self.has_attn)
        want_fd = fused_decode_enabled() if fused_decode is None \
            else bool(fused_decode)
        self.fused_decode_off_reason: Optional[str] = None
        if want_fd:
            if arch.post_norm:
                self.fused_decode_off_reason = \
                    "fused decode requires a pre-norm stack"
            elif arch.mlm_transform:
                self.fused_decode_off_reason = \
                    "fused decode does not support MLM-transform heads"
            elif not head_ops.tp_fusable(pad_vocab(arch.vocab_size), tp):
                self.fused_decode_off_reason = (
                    f"vocab shard {pad_vocab(arch.vocab_size)}/{tp} does not "
                    f"land on the {head_ops.RED_TILE}-wide reduction tile")
        self.fused_decode = want_fd and self.fused_decode_off_reason is None
        if self.fused_decode and arch.logit_softcap > 0:
            raise _not_ported("fused decode with a logit softcap",
                              "a later slice adds it to head_tokens")
        self.model = model
        self.arch = arch
        self.device = model.device
        self.page_size = page_size
        self.num_slots = num_slots
        self.max_pages_per_seq = pages_needed(max_seq_len, page_size)
        if prefill_chunk is None:
            prefill_chunk = 4 * page_size
        if prefill_chunk <= 0 or prefill_chunk % page_size:
            raise ValueError("prefill chunk must be a positive page multiple")
        self.prefill_chunk = prefill_chunk
        # the runtime sanitizer and the filter implementation: environment
        # defaults as in JAX, fixed per engine
        self.sanitize = sanitize_enabled() if sanitize is None \
            else bool(sanitize)
        self.fused_sampling = fused_sampling_enabled() \
            if fused_sampling is None else bool(fused_sampling)
        self.decode_steps = int(decode_steps)
        # the reason lands on the engine and in every request's result
        self.prefix_cache_off_reason = (prefix_cache_off_reason(arch)
                                        if prefix_cache else None)
        prefix_cache = prefix_cache and self.prefix_cache_off_reason is None
        self.scheduler = Scheduler(num_slots=num_slots, num_pages=num_pages,
                                   page_size=page_size,
                                   max_pages_per_seq=self.max_pages_per_seq,
                                   prefix_cache=prefix_cache)
        # ---- tensor parallelism: one engine a rank of ``group`` ----------
        self.tp = tp
        # reduces a layer period: one an attention output, one an MLP / MoE
        # tail (mamba mixers are replicated and reduce nothing)
        self._psums_per_step = sum(
            (1 if kind == "attn" else 0) + (0 if arch.family == "ssm" else 1)
            for kind in kinds) * (arch.num_layers // len(kinds))
        self.collective_bytes = 0       # analytic TP wire bytes per rank
        self.group, self.rank = None, 0
        blocks = model.params["blocks"]
        pool_arch = arch
        if tp > 1:
            self.group, self.rank = _tp_group(group, tp)
            _check_shard(model, self.rank, tp)
            # the clock's broadcast: from the group's rank 0, through the
            # card under nccl (which moves only card tensors)
            self._clock_from = (
                dist.get_global_rank(self.group, 0),
                self.device if dist.get_backend(self.group) == "nccl"
                else torch.device("cpu"))
            # each rank's pools hold its heads of every page
            pool_arch = dataclasses.replace(
                arch, num_kv_heads=arch.num_kv_heads * self.kv_rep // tp)
            if decode_steps > 1 and self.device.type == "cuda" and \
                    dist.get_backend(self.group) != "nccl":
                raise ValueError(
                    f"decode_steps={decode_steps} at tp={tp} captures the "
                    f"decode iteration with its collectives in a CUDA "
                    f"graph, which the {dist.get_backend(self.group)!r} "
                    "backend cannot be captured in; use nccl (a card a "
                    "rank) or decode_steps=1")
        self.blocks = blocks
        self.pools = tf.init_serving_state(pool_arch, num_pages, page_size,
                                           num_slots, model.dtype,
                                           self.device)
        self.steps = 0                  # decode steps executed
        self.decode_dispatches = 0      # host round trips those steps cost
        # why multi-step dispatches came back to the host (per active slot
        # bit for eos / budgets; one count per full-horizon dispatch)
        self.decode_exits = {"eos": 0, "token_budget": 0, "page_budget": 0,
                             "horizon": 0}
        self.prefills = 0               # prefill completions
        self.prefill_chunks = 0         # prefill chunks executed
        self.prefill_tokens = 0         # prompt tokens actually computed
        self.cached_prefill_tokens = 0  # prompt tokens served from the cache
        self.cow_copies = 0             # divergent tail pages duplicated
        self._prefilling: Deque[SequenceState] = deque()
        # step variant key (JAX's jit-cache key) -> traces behind it
        self._traces: Dict[Tuple, int] = {}
        # finite probes still on the device, read with the next tokens
        self._pending: List[Tuple[torch.Tensor, str]] = []
        # per-slot sampling arrays on the host, and on the device for N=1
        self._null_host = (np.zeros((num_slots,), np.int64),
                           np.zeros((num_slots,), np.float32),
                           np.zeros((num_slots,), np.int32),
                           np.ones((num_slots,), np.float32))
        self._null_sampling = self._sampling_tensors(*self._null_host)
        self._sampling_key: Optional[Tuple] = None
        self._sampling_host = self._null_host
        self._sampling_args = self._null_sampling
        self._loop = DecodeLoop(num_slots, self.max_pages_per_seq,
                                self.decode_steps, self.device,
                                group=self.group) \
            if self.decode_steps > 1 else None

    # -------------------------------------------------------------- helpers --
    def _sampling_tensors(self, seeds, temps, top_ks, top_ps):
        dev = self.device
        return (torch.as_tensor(np.asarray(seeds, np.int64), device=dev),
                torch.as_tensor(np.asarray(temps, np.float32), device=dev),
                torch.as_tensor(np.asarray(top_ks, np.int32), device=dev),
                torch.as_tensor(np.asarray(top_ps, np.float32), device=dev))

    def _ints(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=self.device)

    def _clock(self, value: float) -> float:
        """The scheduler's clock reading ``value`` as every rank sees it:
        at tp > 1 rank 0's, broadcast (one float64), so that every rank
        admits, preempts and sleeps at the same iterations and records
        rank 0's token times."""
        if self.group is None:
            return value
        src, dev = self._clock_from
        t = torch.tensor([value], dtype=torch.float64, device=dev)
        dist.broadcast(t, src=src, group=self.group)
        return float(t.item())

    def _tp_collective_bytes(self, positions: int) -> int:
        """JAX's analytic wire bytes a rank for one step's reduces: one
        fp32 [positions, d_model] ring all-reduce a reduce site (attention
        output, MLP output or MoE combine; mamba mixers none), each moving
        2 (tp - 1) / tp of its payload a rank."""
        if self.tp <= 1:
            return 0
        payload = positions * self.arch.d_model * 4
        return self._psums_per_step * payload * 2 * (self.tp - 1) // self.tp

    def _note_trace(self, key: Tuple) -> None:
        """Record a first use of the step variant ``key``."""
        self._traces.setdefault(key, 1)

    def _read(self, values: Sequence[torch.Tensor],
              probes: Sequence[Tuple[torch.Tensor, str]] = ()
              ) -> List[np.ndarray]:
        """Copy ``values`` (int32 tensors) to the host in one copy, together
        with every finite probe still pending and ``probes`` ((flag,
        where) pairs); check the probes in order, then return the values.
        Without probes a single value is copied alone."""
        probes = self._pending + list(probes)
        self._pending = []
        if not probes and len(values) == 1:
            return [values[0].cpu().numpy().copy()]
        flat = [v.reshape(-1).int() for v in values] \
            + [p.reshape(1).int() for p, _ in probes]
        words = torch.cat(flat).cpu().numpy()
        out, off = [], 0
        for v in values:
            out.append(words[off:off + v.numel()].reshape(v.shape))
            off += v.numel()
        for j, (_, where) in enumerate(probes):
            check_finite_probe(bool(words[off + j]), where)
        return out

    def _select(self, logits, seeds, positions, temps, top_ks, top_ps, *,
                sampled: bool, filtered: bool) -> torch.Tensor:
        if not sampled:
            return torch.argmax(logits, dim=-1).int()
        return sample_tokens(logits, seeds, positions, temps, top_ks, top_ps,
                             filtered=filtered,
                             fused=self.fused_sampling and filtered)

    def _fused_head(self, x, positions, seeds, temps, top_ks, top_ps, *,
                    sampled: bool, filtered: bool):
        """Final norm + the fused LM head: final hidden ``x`` [S, 1, D] ->
        ``(tokens int32 [S], ok bool [S])`` (``ok``: the raw logits of the
        row are all finite). The kernel reads the tied embedding [V, D] or
        the untied head ``out.head`` [D, V] in place, and derives each
        row's draw uniform from the determinism contract's key, its seed
        and position, on the card."""
        params = self.model.params
        hidden = apply_norm(self.arch.norm, params["final_norm"], x)[:, 0]
        untied = not self.arch.tie_embeddings
        w = params["out"]["head"] if untied else params["embed"]["embedding"]
        return head_ops.head_tokens(
            hidden, w, seeds, positions, temps, top_ks, top_ps,
            sampled=sampled, filtered=filtered, untied=untied)

    # ----------------------------------------------------------------- steps --
    @torch.inference_mode()
    def _decode(self, page_table: np.ndarray, seq_lens: np.ndarray,
                tokens: np.ndarray, sampling_args, *, sampled: bool,
                filtered: bool) -> np.ndarray:
        """tokens [S] -> next tokens [S] (host). The emitted token's stream
        position is seq_lens + 1, derived on the device. With the sanitizer
        the live rows' finite probe comes back with the tokens."""
        self._note_trace(("decode", sampled, filtered,
                          self.fused_sampling and filtered,
                          self.fused_decode))
        pt, sl = self._ints(page_table), self._ints(seq_lens)
        x = self.model._embed(self._ints(tokens)[:, None])
        x = tf.paged_decode_stack(self.arch, self.blocks, self.pools, x, pt,
                                  sl, fused=self.fused_decode,
                                  group=self.group)
        where, probes = f"decode step {self.steps}", []
        if self.fused_decode:
            tok, ok = self._fused_head(x, sl + 1, *sampling_args,
                                       sampled=sampled, filtered=filtered)
            if self.sanitize:
                probes.append(((ok | (sl == 0)).all(), where))
        else:
            logits = self.model._logits(x)[:, 0]
            tok = self._select(logits, sampling_args[0], sl + 1,
                               *sampling_args[1:], sampled=sampled,
                               filtered=filtered)
            if self.sanitize:
                # inactive slots read the null page and may produce junk:
                # probe only rows with a token resident
                live = torch.isfinite(logits) | (sl[:, None] == 0)
                probes.append((live.all(), where))
        return self._read([tok], probes)[0]

    @torch.inference_mode()
    def _decode_multi(self, page_table: np.ndarray, seq_lens: np.ndarray,
                      tokens: np.ndarray, active: np.ndarray,
                      budget: np.ndarray, page_limit: np.ndarray,
                      eos_ids: np.ndarray, sampling_host, k: int, *,
                      sampled: bool, filtered: bool
                      ) -> Tuple[int, np.ndarray, np.ndarray]:
        """One multi-step dispatch: stage the inputs, run ``k`` loop
        iterations (graph replays on the card), then one copy back ->
        (iterations run, exit bits [S], emitted tokens [N, S]). ``active``,
        ``budget``, ``page_limit`` and ``eos_ids`` are the host's per-slot
        loop predicates, as JAX's."""
        horizon, loop = self.decode_steps, self._loop
        fused = self.fused_sampling and filtered
        key = ("decode", sampled, filtered, fused, self.fused_decode,
               horizon)
        seeds_h, temps_h, top_ks_h, top_ps_h = sampling_host
        loop.stage(page_table=page_table, seq_lens=seq_lens, tokens=tokens,
                   active=active, budget=budget, page_limit=page_limit,
                   eos_ids=eos_ids, seeds=seeds_h, temps=temps_h,
                   top_ks=top_ks_h, top_ps=top_ps_h)
        c = loop.carry
        samp = (c["seeds"], c["temps"], c["top_k"], c["top_p"])
        flags = {"sampled": sampled, "filtered": filtered}
        step = functools.partial(
            tf.paged_decode_loop_step, self.arch, self.blocks, self.pools, c,
            horizon=horizon, embed=self.model._embed, probe=self.sanitize,
            group=self.group)
        if self.fused_decode:
            step = functools.partial(step, fused_head=lambda x, pos:
                                     self._fused_head(x, pos, *samp, **flags))
        else:
            step = functools.partial(
                step, unembed=lambda x: self.model._logits(x)[:, 0],
                select=lambda lg, pos: self._select(
                    lg, samp[0], pos, *samp[1:], **flags))
        pools = tuple(t.data_ptr() for p in self.pools for t in p.values())
        if loop.run(key, k, step, pools):
            self._traces[key] = self._traces.get(key, 0) + 1
        self._note_trace(key)
        steps, ok, exits, buf = loop.unpack(self._read([loop.read()])[0])
        if self.sanitize:
            check_finite_probe(ok, f"multi-step decode dispatch "
                                   f"{self.decode_dispatches} (horizon "
                                   f"{horizon})")
        return max(1, steps), exits, buf

    @torch.inference_mode()
    def _prefill(self, chunk: np.ndarray, page_row: np.ndarray, slot: int,
                 start: int, end: int, sp, *, final: bool,
                 moe_cap: Optional[int] = None):
        """One prompt chunk of one sequence (in ``slot``, whose mamba state
        rows it advances; its MoE layers drop at ``moe_cap``, the full
        prompt's capacity) -> ``(token, probe)``: on the final chunk the
        token after position ``end - 1`` (stream position ``end``) as an
        int32 [1] device tensor, else None; with the sanitizer the chunk's
        finite probe (a 0-d device flag: the valid positions' activations,
        or the final chunk's logits), else None."""
        sampled = final and not sp.greedy
        filtered = sampled and sp.filtered
        self._note_trace(("prefill", final, sampled, filtered,
                          self.fused_sampling and filtered,
                          self.fused_decode))
        x = self.model._embed(self._ints(chunk))
        x = tf.paged_prefill_stack(self.arch, self.blocks, self.pools, x,
                                   self._ints(page_row), start, end, slot,
                                   fused=self.fused_decode, moe_cap=moe_cap,
                                   group=self.group)
        if not final:
            if not self.sanitize:
                return None, None
            # pad rows past the chunk's valid tokens may be junk
            pad = torch.arange(x.shape[1], device=x.device) >= end - start
            return None, (torch.isfinite(x) | pad[None, :, None]).all()
        xl = tf.chunk_final_hidden(x, start, end)
        args = self._sampling_tensors([sp.seed], [sp.temperature],
                                      [sp.top_k], [sp.top_p])
        flags = {"sampled": sampled, "filtered": filtered}
        if self.fused_decode:
            tok, ok = self._fused_head(xl, self._ints([end]), *args, **flags)
            probe = ok[0]
        else:
            logits = self.model._logits(xl)[:, 0]
            tok = self._select(logits, args[0], self._ints([end]), *args[1:],
                               **flags)
            probe = torch.isfinite(logits).all()
        return tok, (probe if self.sanitize else None)

    @torch.inference_mode()
    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate one physical page in every attention
        layer's pool. Mamba slot state has no pages (CoW exists only under
        prefix caching, which SSM-bearing archs gate off)."""
        for pool in self.pools:
            if "k" not in pool:
                continue
            pool["k"][dst].copy_(pool["k"][src])
            pool["v"][dst].copy_(pool["v"][src])

    # --------------------------------------------------------------- prefill --
    def _start_prefill(self, seq: SequenceState) -> None:
        """Execute the admission's CoW copy (if any) and queue the suffix."""
        if seq.cow is not None:
            self._copy_page(*seq.cow)
            self.scheduler.cow_done(seq)
            self.cow_copies += 1
        self.cached_prefill_tokens += seq.cached_len
        self._prefilling.append(seq)

    def _advance_prefill(self, now) -> None:
        """Run ONE chunk of the oldest pending prefill; on the final chunk
        emit the sequence's next token and publish its pages."""
        sched = self.scheduler
        while self._prefilling:
            seq = self._prefilling[0]
            if sched.running.get(seq.slot) is not seq:
                self._prefilling.popleft()      # preempted while waiting
                continue
            ctx = seq.context
            start = seq.prefilled
            end = min(start + self.prefill_chunk, seq.prefill_target)
            chunk = np.zeros((1, self.prefill_chunk), np.int32)
            chunk[0, :end - start] = ctx[start:end]
            final = end == seq.prefill_target
            # the full context's MoE capacity, computed on the host with the
            # math of the static engine's dispatch (capacity_per_row)
            moe_cap = capacity_per_row(seq.prefill_target, self.arch.moe) \
                if self.arch.moe is not None else None
            tok, probe = self._prefill(
                chunk, sched.cache.page_table[seq.slot], seq.slot, start,
                end, seq.request.sampling, final=final, moe_cap=moe_cap)
            if probe is not None:
                # read with the next tokens the host copies back
                self._pending.append((probe, (
                    f"prefill chunk [{start}:{end}) of request "
                    f"{seq.request.uid} (final={final})")))
            if final:
                # the one read of a final chunk: its token (and probes)
                tok = int(self._read([tok])[0][0])
            seq.prefilled = end
            self.prefill_chunks += 1
            self.prefill_tokens += end - start
            self.collective_bytes += self._tp_collective_bytes(
                self.prefill_chunk)
            if final:
                self._prefilling.popleft()
                self.prefills += 1
                sched.register_prefix(seq.slot, ctx)
                seq.generated.append(tok)
                seq.token_times.append(now())
            return

    def _prefill_pending(self, slot: int) -> bool:
        seq = self.scheduler.running.get(slot)
        return seq is not None and seq.prefilled < seq.prefill_target

    # ------------------------------------------------------------------- run --
    def run(self, requests: Sequence[Request], *,
            time_fn=time.perf_counter) -> Dict[int, dict]:
        """Serve a trace to completion. Requests with ``arrival > 0`` are held
        back until the trace clock reaches them. Returns
        uid -> {"tokens", "token_times", "prompt_len",
        "cached_prefill_tokens"[, "prefix_cache"][, "error"]}, where
        "prefix_cache" is "off: <reason>" when the engine gated the cache
        off."""
        sched = self.scheduler
        pending = deque(sorted(requests, key=lambda r: (r.arrival, r.uid)))
        results: Dict[int, dict] = {}
        t0 = time_fn()
        skip = 0.0                      # simulated idle time (frozen time_fn)

        def now() -> float:
            # rank 0's reading at tp > 1
            return self._clock(time_fn() - t0 + skip)

        def finish(seq: SequenceState) -> None:
            # context[:-1] is what is in the pages (the last generated
            # token's K/V was never written)
            sched.register_prefix(seq.slot, seq.context[:-1])
            sched.finish(seq)
            results[seq.request.uid] = {
                "tokens": list(seq.generated),
                "token_times": list(seq.token_times),
                "prompt_len": len(seq.request.prompt),
                "cached_prefill_tokens": seq.cached_len,
            }
            if self.prefix_cache_off_reason is not None:
                results[seq.request.uid]["prefix_cache"] = \
                    f"off: {self.prefix_cache_off_reason}"
            if self.sanitize:
                # the host invariants at every request boundary: a leak or
                # a desync raises naming the request that exposed it
                check_engine(self)

        while pending or sched.has_work:
            while pending and pending[0].arrival <= now():
                sched.submit(pending.popleft())

            while self._prefilling and sched.running.get(
                    self._prefilling[0].slot) is not self._prefilling[0]:
                self._prefilling.popleft()
            # with the prefix cache on, admit one request per iteration and
            # only while no prefill is in flight, so a later request can
            # prefix-match the pages the current one is about to register
            while sched.prefix is None or not self._prefilling:
                seq = sched.admit_next()
                if seq is None:
                    break
                self._start_prefill(seq)
            for req in sched.take_rejected():
                results[req.uid] = {
                    "tokens": [], "token_times": [],
                    "prompt_len": len(req.prompt),
                    "error": "context exceeds max_seq_len "
                             f"({self.max_pages_per_seq} pages/seq)",
                }

            self._advance_prefill(now)
            for slot in list(sched.running):
                seq = sched.running[slot]
                if seq.done and not self._prefill_pending(slot):
                    finish(seq)

            if not sched.running:
                if pending:
                    wait = max(0.0, pending[0].arrival - now())
                    before = now()
                    time.sleep(min(1e-3, wait))
                    if now() <= before:
                        skip += max(wait, 1e-9)
                    continue
                if sched.queue:
                    seq = sched.admit_next()
                    if seq is None:
                        raise RuntimeError(
                            "queue stalled: page pool cannot admit any "
                            "request")
                    self._start_prefill(seq)
                    continue
                break

            sched.ensure_capacity()     # may preempt; victims re-enter later

            slots = [s for s in sched.running_slots()
                     if not self._prefill_pending(s)]
            if not slots:
                continue
            cache = sched.cache
            horizon = self.decode_steps
            if horizon > 1:
                # the multi-step loop's per-slot predicates, built BEFORE
                # the page table is snapshotted: extend_capacity appends
                # the pages the loop may write. budget is the remaining
                # max-new / context allowance (>= 1: done sequences were
                # finished above)
                h_active = np.zeros((self.num_slots,), np.int32)
                h_budget = np.ones((self.num_slots,), np.int32)
                h_pages = np.zeros((self.num_slots,), np.int32)
                h_eos = np.full((self.num_slots,), -1, np.int32)
                for slot in slots:
                    seq = sched.running[slot]
                    req = seq.request
                    h_active[slot] = 1
                    left = min(
                        req.max_new_tokens - len(seq.generated),
                        seq.max_context - len(req.prompt)
                        - len(seq.generated))
                    h_budget[slot] = left
                    h_pages[slot] = sched.extend_capacity(
                        slot, min(horizon, left))
                    if req.eos_id is not None:
                        h_eos[slot] = req.eos_id
            page_table, seq_lens = cache.page_table, cache.seq_lens
            if len(slots) != len(sched.running):
                page_table = page_table.copy()
                seq_lens = seq_lens.copy()
                for s in sched.running:
                    if self._prefill_pending(s):
                        page_table[s] = 0
                        seq_lens[s] = 0
            tokens = np.zeros((self.num_slots,), np.int32)
            for slot in slots:
                tokens[slot] = sched.running[slot].generated[-1]
            active = [sched.running[s].request.sampling for s in slots]
            sampled = any(not sp.greedy for sp in active)
            filtered = any(not sp.greedy and sp.filtered for sp in active)
            if sampled:
                comp = tuple((s, sched.running[s].request.sampling)
                             for s in slots)
                if comp != self._sampling_key:
                    seeds = np.zeros((self.num_slots,), np.int64)
                    temps = np.zeros((self.num_slots,), np.float32)
                    top_ks = np.zeros((self.num_slots,), np.int32)
                    top_ps = np.ones((self.num_slots,), np.float32)
                    for slot in slots:
                        sp = sched.running[slot].request.sampling
                        seeds[slot] = sp.seed
                        temps[slot] = sp.temperature
                        top_ks[slot] = sp.top_k
                        top_ps[slot] = sp.top_p
                    self._sampling_host = (seeds, temps, top_ks, top_ps)
                    if horizon == 1:
                        self._sampling_args = self._sampling_tensors(
                            seeds, temps, top_ks, top_ps)
                    self._sampling_key = comp
                sampling_host = self._sampling_host
                sampling_args = self._sampling_args
            else:
                sampling_host = self._null_host
                sampling_args = self._null_sampling
            if horizon == 1:
                next_np = self._decode(page_table, seq_lens, tokens,
                                       sampling_args, sampled=sampled,
                                       filtered=filtered)
                self.steps += 1
                self.decode_dispatches += 1
                self.collective_bytes += self._tp_collective_bytes(
                    self.num_slots)
                t_tok = now()
                for slot in slots:
                    seq = sched.running[slot]
                    cache.seq_lens[slot] += 1    # input token now cached
                    seq.generated.append(int(next_np[slot]))
                    seq.token_times.append(t_tok)
                    if seq.done:
                        finish(seq)
                continue

            # multi-step dispatch: up to `horizon` iterations, one host
            # synchronisation, then the loop's effects replayed through
            # the ordinary finish path
            k, reasons, buf = self._decode_multi(
                page_table, seq_lens, tokens, h_active, h_budget, h_pages,
                h_eos, sampling_host,
                self._loop_iterations(slots, seq_lens, h_budget, h_pages),
                sampled=sampled, filtered=filtered)
            self.steps += k
            self.decode_dispatches += 1
            self.collective_bytes += k * self._tp_collective_bytes(
                self.num_slots)
            for name, bit in (("eos", tf.EXIT_EOS),
                              ("token_budget", tf.EXIT_BUDGET),
                              ("page_budget", tf.EXIT_PAGES)):
                self.decode_exits[name] += \
                    int(((reasons[slots] & bit) != 0).sum())
            if k == horizon and not reasons[slots].any():
                self.decode_exits["horizon"] += 1
            t_tok = now()
            for slot in slots:
                seq = sched.running[slot]
                cache.seq_lens[slot] += k        # k input tokens now cached
                seq.generated.extend(int(t) for t in buf[:k, slot])
                seq.token_times.extend([t_tok] * k)
                if seq.done:
                    finish(seq)
        if self._pending:
            self._read([])
        return results

    def _loop_iterations(self, slots: Sequence[int], seq_lens: np.ndarray,
                         budget: np.ndarray, page_limit: np.ndarray) -> int:
        """The iterations a dispatch runs: all the loop can run unless an
        EOS ends it sooner (the host can predict every other exit: the
        budget bit ends it after min(budget) iterations, the page check
        before a slot's length reaches its page limit). Iterations past
        an EOS are no-ops on the card."""
        return int(min(self.decode_steps, budget[slots].min(),
                       (page_limit[slots] - seq_lens[slots]).min()))

    # ----------------------------------------------------------------- stats --
    @property
    def live_kv_tokens(self) -> int:
        return self.scheduler.cache.live_tokens

    @property
    def pages_in_use(self) -> int:
        return self.scheduler.allocator.used_count

    def tp_stats(self) -> Dict[str, object]:
        """Tensor-parallel accounting, JAX's keys. Page ids are global
        under head sharding, so each rank holds its heads of every page in
        use: its pages equal the global count, its KV bytes are 1 / tp of
        them (times ``kv_rep`` where tp > Hkv replicates KV heads). Mamba
        layers hold no pages; their replicated slot state is
        ``ssm_state_bytes``. ``collective_bytes_per_device`` is the
        analytic ring all-reduce wire traffic a rank of the reduces."""
        arch = self.arch
        kinds = tf.layer_kinds(arch)
        nper = arch.num_layers // len(kinds)
        n_attn = sum(k == "attn" for k in kinds) * nper
        n_mamba = len(kinds) * nper - n_attn
        itemsize = self.model.dtype.itemsize
        page_bytes = (self.page_size * arch.num_kv_heads
                      * arch.resolved_head_dim * 2 * n_attn * itemsize)
        ssm_bytes = 0
        if n_mamba:
            sc = arch.ssm
            ssm_bytes = n_mamba * self.num_slots * (
                ssm_lib.num_ssm_heads(arch) * sc.state_dim * sc.head_dim * 4
                + (sc.conv_width - 1) * ssm_lib.conv_channels(arch)
                * itemsize)
        return {
            "tp": self.tp,
            "kv_head_replication": self.kv_rep,
            "collective_bytes_per_device": self.collective_bytes,
            "per_device": {
                "pages_in_use": self.pages_in_use,
                "kv_bytes": self.pages_in_use * page_bytes * self.kv_rep
                // self.tp,
                "ssm_state_bytes": ssm_bytes,
            },
        }

    def trace_stats(self) -> Dict[str, int]:
        """Variant accounting, JAX's keys: ``variants`` is the number of
        step variants the traffic exercised, ``traces`` the traces behind
        them (a graph capture on the card, a first use otherwise) and
        ``excess`` their difference: a recapture, which must stay 0."""
        traces = sum(self._traces.values())
        return {"variants": len(self._traces), "traces": traces,
                "excess": traces - len(self._traces)}
