"""Continuous-batching scheduler: admission, prefix cache, slot recycling,
preemption. The port's own copy of ``repro.serving.scheduler``, unchanged
in logic.

Pure host logic (no tensors): the engine asks the scheduler *what* to run each
step; the scheduler owns the request queue, the fixed pool of decode slots,
the page allocator, and the prefix index.

Policies
--------
admission   FIFO; a queued request is admitted when a slot is free AND the
            allocator can hand over the pages for its prompt plus one decode
            token, leaving >= 1 free page of headroom whenever other
            sequences are running (otherwise the freshly prefilled admit is
            the first preemption victim the moment any neighbour grows —
            admit/preempt thrash). A request whose context cannot fit in
            ``max_pages_per_seq`` is rejected on its own (surfaced via
            ``take_rejected``) instead of killing the engine.
prefix      requests are matched against a hash-chained index of cached KV
            pages: the longest page-aligned prefix is shared (refcounted,
            stored once), a partially matching tail page is copied on
            divergence (CoW — the engine performs the device copy), and only
            the remaining suffix is prefilled. Index entries are evicted LRU
            (leaf-first) under pool pressure, before any preemption.
growth      crossing a page boundary mid-decode allocates one page. If the
            pool is exhausted (after evicting cached prefixes), the most
            recently admitted sequence is preempted (forced replay: its
            pages are freed and it rejoins the front of the queue carrying
            the tokens generated so far — on re-admission that context is
            re-prefilled *forced*, no token is re-decided, and the next
            token's (seed, position) PRNG key is the one the uninterrupted
            run would have used, so the continuation is token-identical
            under any sampling setting; the re-prefill typically prefix-hits
            the sequence's own surviving cached pages). Forced replay is
            also what makes preemption layer-kind-agnostic: a mamba mixer's
            per-slot recurrent state is never checkpointed — replaying the
            context recomputes it exactly, so the scheduler needs no
            per-kind state bookkeeping (engines serving SSM-bearing archs
            simply run with ``prefix_cache=False``; pages remain the
            admission/growth currency either way).
recycling   EOS / max-new-tokens frees the slot and its pages in O(1); the
            next queued request takes the slot without touching the compiled
            decode step (fixed batch, inactive slots masked by seq_len 0).
horizon     multi-step decode (engine ``decode_steps > 1``) pre-allocates
            up to a horizon's worth of pages per slot via
            ``extend_capacity`` BEFORE the dispatch: free pages only, never
            an eviction or preemption, and always leaving a reserve of
            ``(running - 1) + (1 if queued)`` free pages — so single-step
            preemption timing is unchanged and a starved pool degrades to
            shorter dispatches, not to new preemptions.

Slot lifecycle formula (the sanitizer re-checks it after every request):
a slot is either free (``seq_len == 0``, no pages, not in ``running``) or
owned by exactly one sequence, whose cache length is

    seq_len == prefill_target              while chunk-prefilling,
    seq_len == len(prompt) + len(generated) - 1   while decoding

(the -1: the newest token's KV is written by the step that consumes it),
and every allocated page is owned by exactly one slot or refcounted by the
prefix index — allocator free + owned + cached == num_pages, always.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from .kv_cache import PageAllocator, PagedCacheState, pages_needed
from .sampling import SamplingParams


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]                   # token ids
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival: float = 0.0                # seconds into the trace
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)     # greedy unless asked otherwise


@dataclasses.dataclass
class SequenceState:
    request: Request
    slot: int
    admit_order: int
    generated: List[int] = dataclasses.field(default_factory=list)
    token_times: List[float] = dataclasses.field(default_factory=list)
    cached_len: int = 0        # context tokens served from the prefix cache
    prefilled: int = 0         # context tokens whose K/V is in pages so far
    prefill_target: int = 0    # context length at admission (prefill is done
                               # when prefilled reaches it; ``context`` itself
                               # keeps growing as tokens are generated)
    max_context: int = 1 << 30  # page-table capacity in tokens (set at
                                # admission): generation is truncated here
                                # rather than overflowing the page table
    cow: Optional[Tuple[int, int]] = None   # (src_page, dst_page) to copy

    @property
    def context(self) -> List[int]:
        """Tokens whose K/V must be in cache: prompt + generated so far."""
        return list(self.request.prompt) + self.generated

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.request.max_new_tokens:
            return True
        if len(self.request.prompt) + len(self.generated) >= self.max_context:
            return True                 # cache capacity: truncate gracefully
        eos = self.request.eos_id
        return eos is not None and len(self.generated) > 0 \
            and self.generated[-1] == eos


_ROOT = -1          # parent "page id" of level-0 edges (no page is -1)

_EdgeKey = Tuple[int, Tuple[int, ...]]      # (parent page id, page's tokens)


@dataclasses.dataclass
class _CachedPage:
    """One radix edge: a physical page holding K/V for ``key[1]`` (this
    page's token slice), hanging off the parent *page* ``key[0]``."""
    key: _EdgeKey
    parent_key: Optional[_EdgeKey]          # None for level-0 edges
    page: int
    last_used: int
    children: int = 0


class PrefixIndex:
    """Radix index over cached KV pages.

    Full pages form a tree whose edges are keyed by (parent page id, this
    page's ``page_size`` tokens): a physical page id is unique while the
    index holds it, so the pair is a real radix edge — matching a k-page
    prefix is k dict hits of O(page_size) keys, and memory is linear in the
    cached token count (not quadratic, as keying by the whole prefix would
    be). Partial tail pages (< page_size tokens) are kept per parent node
    and matched by longest common prefix; a hit is served copy-on-write.

    The index holds one allocator reference per entry, so cached pages
    survive the sequences that wrote them; ``evict_one`` drops LRU leaves
    when the pool needs pages back.
    """

    def __init__(self, allocator: PageAllocator, page_size: int,
                 max_partials_per_node: int = 4):
        self.allocator = allocator
        self.page_size = page_size
        self.max_partials_per_node = max_partials_per_node
        self._full: Dict[_EdgeKey, _CachedPage] = {}
        # parent page id -> {tail tokens -> entry}
        self._partials: Dict[int, Dict[Tuple[int, ...], _CachedPage]] = {}
        # page id -> number of index entries holding it, maintained
        # incrementally at entry creation/removal (the same physical page can
        # carry both a partial entry and a later full entry). Rebuilding this
        # map per evict_one()/reclaimable() call made eviction bursts O(pages
        # freed * index entries).
        self._holds: Dict[int, int] = {}
        self._clock = 0
        self.hits = 0
        self.misses = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _hold(self, page: int) -> None:
        self._holds[page] = self._holds.get(page, 0) + 1

    def _unhold(self, page: int) -> None:
        n = self._holds[page] - 1
        if n:
            self._holds[page] = n
        else:
            del self._holds[page]

    @property
    def num_entries(self) -> int:
        return len(self._full) + sum(len(b) for b in self._partials.values())

    def reclaimable(self) -> int:
        """Pages that evicting index entries would actually free right now:
        those whose every allocator hold belongs to the index (no running
        sequence shares them)."""
        return sum(1 for p, n in self._holds.items()
                   if self.allocator.ref_count(p) == n)

    # ------------------------------------------------------------------ match ---
    def match(self, tokens: Sequence[int]
              ) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Longest chain of cached full pages matching ``tokens``, plus an
        optional partially matching tail ``(page, lcp_tokens)``. Does not
        take references — the caller pins what it keeps."""
        pages: List[int] = []
        parent = _ROOT
        n = 0
        while (n + 1) * self.page_size <= len(tokens):
            e = self._full.get(
                (parent, tuple(tokens[n * self.page_size:
                                      (n + 1) * self.page_size])))
            if e is None:
                break
            e.last_used = self._tick()
            pages.append(e.page)
            parent = e.page
            n += 1
        rest = tuple(tokens[n * self.page_size:])
        best: Optional[_CachedPage] = None
        best_lcp = 0
        for tail_toks, e in self._partials.get(parent, {}).items():
            lcp = 0
            for a, b in zip(tail_toks, rest):
                if a != b:
                    break
                lcp += 1
            if lcp > best_lcp:
                best, best_lcp = e, lcp
        if best is not None:
            best.last_used = self._tick()
        if pages or best is not None:
            self.hits += 1
        else:
            self.misses += 1
        return pages, (best.page, best_lcp) if best is not None else None

    # ----------------------------------------------------------------- insert ---
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> None:
        """Register the pages holding K/V for ``tokens`` (page i covers
        tokens[i*page : (i+1)*page]). Existing entries win — the same logical
        prefix re-prefilled into different physical pages is already cached —
        and deeper levels chain off the *index's* page, so the tree stays one
        connected radix structure."""
        parent, parent_key = _ROOT, None
        n_full = len(tokens) // self.page_size
        for i in range(n_full):
            key = (parent,
                   tuple(tokens[i * self.page_size:(i + 1) * self.page_size]))
            e = self._full.get(key)
            if e is None:
                self.allocator.incref(pages[i])
                self._hold(pages[i])
                e = _CachedPage(key=key, parent_key=parent_key,
                                page=pages[i], last_used=self._tick())
                self._full[key] = e
                if parent_key is not None:
                    self._full[parent_key].children += 1
            else:
                e.last_used = self._tick()
            parent, parent_key = e.page, e.key
        rem = tuple(tokens[n_full * self.page_size:])
        if not rem or n_full >= len(pages):
            return
        bucket = self._partials.setdefault(parent, {})
        if rem in bucket:
            bucket[rem].last_used = self._tick()
            return
        if len(bucket) >= self.max_partials_per_node:
            lru = min(bucket, key=lambda t: bucket[t].last_used)
            self._drop_partial(parent, lru)
        self.allocator.incref(pages[n_full])
        self._hold(pages[n_full])
        bucket[rem] = _CachedPage(key=(parent, rem), parent_key=parent_key,
                                  page=pages[n_full], last_used=self._tick())
        if parent_key is not None:
            self._full[parent_key].children += 1

    # --------------------------------------------------------------- eviction ---
    def _drop_partial(self, parent: int, tail: Tuple[int, ...]) -> None:
        e = self._partials[parent].pop(tail)
        if not self._partials[parent]:
            del self._partials[parent]
        if e.parent_key is not None:
            self._full[e.parent_key].children -= 1
        self._unhold(e.page)
        self.allocator.free([e.page])

    def evict_one(self) -> bool:
        """Evict a *leaf* entry (a page no longer on any cached chain's
        interior — evicting interiors first would orphan ref-held
        descendants), preferring LRU among leaves whose page would actually
        return to the free list: dropping an entry for a page a running
        sequence still shares frees nothing and just destroys cache later
        requests would hit. Non-reclaimable leaves go only when no
        reclaimable leaf exists (to unblock reclaimable interiors behind
        them). Returns False when the index is empty."""
        best: Optional[_CachedPage] = None
        fallback: Optional[_CachedPage] = None
        best_partial = fallback_partial = None
        for e in self._full.values():
            if e.children != 0:
                continue
            if self.allocator.ref_count(e.page) == self._holds[e.page]:
                if best is None or e.last_used < best.last_used:
                    best, best_partial = e, None
            elif fallback is None or e.last_used < fallback.last_used:
                fallback, fallback_partial = e, None
        for parent, bucket in self._partials.items():
            for tail, e in bucket.items():
                if self.allocator.ref_count(e.page) == self._holds[e.page]:
                    if best is None or e.last_used < best.last_used:
                        best, best_partial = e, (parent, tail)
                elif fallback is None or e.last_used < fallback.last_used:
                    fallback, fallback_partial = e, (parent, tail)
        if best is None:
            best, best_partial = fallback, fallback_partial
        if best is None:
            return False
        if best_partial is not None:
            self._drop_partial(*best_partial)
            return True
        del self._full[best.key]
        if best.parent_key is not None:
            self._full[best.parent_key].children -= 1
        self._unhold(best.page)
        self.allocator.free([best.page])
        return True


class Scheduler:
    def __init__(self, *, num_slots: int, num_pages: int, page_size: int,
                 max_pages_per_seq: int, prefix_cache: bool = False):
        self.allocator = PageAllocator(num_pages)
        self.cache = PagedCacheState(num_slots, max_pages_per_seq, page_size)
        self.page_size = page_size
        self.prefix: Optional[PrefixIndex] = (
            PrefixIndex(self.allocator, page_size) if prefix_cache else None)
        self.queue: Deque[Request] = deque()
        self.running: Dict[int, SequenceState] = {}     # slot -> seq
        self.rejected: List[Request] = []
        self._free_slots: List[int] = list(range(num_slots - 1, -1, -1))
        # uid -> (generated, token_times) carried across a preemption
        self._partial: Dict[int, tuple] = {}
        self._admit_counter = 0

    # ------------------------------------------------------------- submission ---
    def submit(self, request: Request) -> None:
        self.queue.append(request)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.running)

    def take_rejected(self) -> List[Request]:
        out, self.rejected = self.rejected, []
        return out

    # -------------------------------------------------------------- admission ---
    def admit_next(self) -> Optional[SequenceState]:
        """Admit the head-of-queue request if a slot and pages are available.

        Matches the longest cached page-aligned prefix (sharing those pages),
        schedules a CoW copy for a partially matching tail page, and
        allocates fresh pages for the rest of the context (prompt + any
        tokens a preempted sequence already generated) plus one decode token.
        Returns the SequenceState (suffix prefill still owed by the engine)
        or None. Requests that can never fit are dropped into ``rejected``
        and admission moves on to the next request.
        """
        while self.queue and self._free_slots:
            # cheap pre-check before the radix walk: even a full prefix hit
            # needs one fresh page (plus headroom) — when nothing is
            # obtainable, skip the per-iteration match/incref/undo churn a
            # blocked head request would otherwise repeat every decode step
            # (reclaimable() scans the index, so consult it only when the
            # free list alone is short)
            need_min = 1 + (1 if self.running else 0)
            if self.allocator.free_count < need_min and (
                    self.prefix is None
                    or self.allocator.free_count + self.prefix.reclaimable()
                    < need_min):
                return None
            req = self.queue[0]
            partial = self._partial.get(req.uid, ([], []))
            ctx = list(req.prompt) + partial[0]
            ctx_len = len(ctx)
            n_pages = pages_needed(ctx_len + 1, self.page_size)
            if n_pages > self.cache.max_pages_per_seq:
                # reject this one request; keep serving the rest
                self.queue.popleft()
                self._partial.pop(req.uid, None)
                self.rejected.append(req)
                continue

            matched: List[int] = []
            tail: Optional[Tuple[int, int]] = None
            if self.prefix is not None:
                matched, tail = self.prefix.match(ctx)
                while matched and len(matched) * self.page_size >= ctx_len:
                    matched.pop()       # always leave >= 1 token to prefill
                    tail = None         # its parent chain just shrank
                for pg in matched:
                    self.allocator.incref(pg)
                if tail is not None:
                    lcp = min(tail[1],
                              ctx_len - len(matched) * self.page_size - 1)
                    if lcp <= 0:
                        tail = None
                    else:
                        self.allocator.incref(tail[0])  # pin the CoW source
                        tail = (tail[0], lcp)

            n_fresh = n_pages - len(matched)
            # anti-thrash headroom: never admit into a pool so tight that the
            # first neighbour to grow immediately preempts this admission
            pages = self._alloc_with_eviction(
                n_fresh, reserve=1 if self.running else 0)
            if pages is None:
                if matched:
                    self.allocator.free(matched)
                if tail is not None:
                    self.allocator.free([tail[0]])
                return None

            self.queue.popleft()
            self._partial.pop(req.uid, None)
            slot = self._free_slots.pop()
            seq = SequenceState(req, slot, self._admit_counter,
                                generated=partial[0], token_times=partial[1])
            self._admit_counter += 1
            seq.cached_len = len(matched) * self.page_size
            if tail is not None:
                seq.cow = (tail[0], pages[0])
                seq.cached_len += tail[1]
            seq.prefilled = seq.cached_len
            seq.prefill_target = ctx_len
            # a request whose generation would outgrow the page table ends
            # at capacity instead of asserting out of append_page mid-trace
            seq.max_context = self.cache.max_pages_per_seq * self.page_size
            self.cache.assign(slot, matched + pages, ctx_len)
            self.running[slot] = seq
            return seq
        return None

    def cow_done(self, seq: SequenceState) -> None:
        """The engine copied the CoW tail page; drop the pin on the source."""
        if seq.cow is not None:
            self.allocator.free([seq.cow[0]])
            seq.cow = None

    def register_prefix(self, slot: int, tokens: Sequence[int]) -> None:
        """Publish the slot's pages covering ``tokens`` into the prefix index
        (called after prefill and again when a sequence finishes)."""
        if self.prefix is None or not tokens:
            return
        npg = pages_needed(len(tokens), self.page_size)
        row = [int(p) for p in self.cache.page_table[slot, :npg]]
        self.prefix.insert(list(tokens), row)

    # ----------------------------------------------------------------- growth ---
    def _alloc_with_eviction(self, n: int, reserve: int = 0
                             ) -> Optional[List[int]]:
        """Allocate ``n`` pages, evicting cached prefixes as needed; refuses
        unless ``reserve`` pages would still be free afterwards. Eviction only
        starts when it can actually reach the target — a doomed attempt must
        not strip the index (destroying cached K/V other requests will hit)
        just to fail anyway."""
        target = n + reserve
        if self.allocator.free_count < target and self.prefix is not None \
                and self.allocator.free_count + self.prefix.reclaimable() \
                >= target:
            while self.allocator.free_count < target \
                    and self.prefix.evict_one():
                pass
        if self.allocator.free_count < target:
            return None
        return self.allocator.alloc(n)

    def extend_capacity(self, slot: int, horizon: int) -> int:
        """Best-effort page pre-allocation so ``slot`` can absorb up to
        ``horizon`` more decode tokens without a host resync (the multi-step
        compiled decode loop's page budget). Takes only *free* pages — never
        evicts the prefix index, never preempts, so single-step allocation
        behavior (and preemption timing) is unchanged when the pool runs
        tight — and leaves one free page per other running sequence (plus
        one for the admission queue) so a horizon grab cannot starve a
        neighbour's next-token growth into a preemption that ``horizon=1``
        would not have caused. Returns the slot's resulting token capacity
        (allocated pages x page size): the in-loop write limit the compiled
        loop early-exits on."""
        cache = self.cache
        want = min(pages_needed(int(cache.seq_lens[slot]) + horizon,
                                self.page_size),
                   cache.max_pages_per_seq)
        reserve = max(len(self.running) - 1, 0) + (1 if self.queue else 0)
        while cache.allocated_pages(slot) < want \
                and self.allocator.free_count > reserve:
            pages = self.allocator.alloc(1)
            if pages is None:
                break
            cache.append_page(slot, pages[0])
        return cache.allocated_pages(slot) * self.page_size

    def ensure_capacity(self) -> List[SequenceState]:
        """Allocate next-token pages for every running sequence, evicting
        cached prefixes and then preempting (LIFO by admission) when the pool
        runs dry. Returns preempted seqs."""
        preempted: List[SequenceState] = []
        for slot in sorted(self.running):
            while slot in self.running and self.cache.needs_page(slot):
                pages = self._alloc_with_eviction(1)
                if pages is not None:
                    self.cache.append_page(slot, pages[0])
                    continue
                victim = self._latest_running(exclude=slot)
                if victim is None:
                    raise RuntimeError(
                        "page pool too small for a single sequence: "
                        f"slot {slot} len {int(self.cache.seq_lens[slot])}")
                self._preempt(victim)
                preempted.append(victim)
        return preempted

    def _latest_running(self, exclude: int) -> Optional[SequenceState]:
        cands = [s for s in self.running.values() if s.slot != exclude]
        return max(cands, key=lambda s: s.admit_order) if cands else None

    def _preempt(self, seq: SequenceState) -> None:
        """Free the sequence's memory and put it back at the front of the
        queue; its generated-so-far tokens are kept and re-prefilled as
        *forced* context on re-admission (forced-replay preemption: nothing
        is re-decided, and the next token's (seed, position) sampling key is
        unchanged, so the resumed stream is token-identical even at
        temperature > 0 — and cheap when its prompt pages survive in the
        prefix index)."""
        self.allocator.free(self.cache.release(seq.slot))
        del self.running[seq.slot]
        self._free_slots.append(seq.slot)
        self._partial[seq.request.uid] = (seq.generated, seq.token_times)
        self.queue.appendleft(seq.request)

    # -------------------------------------------------------------- completion --
    def finish(self, seq: SequenceState) -> None:
        self.allocator.free(self.cache.release(seq.slot))
        del self.running[seq.slot]
        self._free_slots.append(seq.slot)

    # ------------------------------------------------------------------ views ---
    def running_slots(self) -> Sequence[int]:
        return sorted(self.running)
