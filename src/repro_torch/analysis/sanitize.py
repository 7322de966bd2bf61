"""Runtime sanitizer for the port's continuous serving engine. The port's
own copy of ``repro.analysis.sanitize``: the same invariants, checks and
``[sanitize:<invariant>]`` messages, word for word.

The scheduler, allocator and prefix index keep a web of host-side
invariants (every physical page accounted for by exactly its holders, every
slot either running or free, the radix index's holds mirroring the
allocator) that ordinary tests only probe at the end of a trace: a
refcount leak or a slot desync mid-trace shows up, if at all, as a
corrupted stream thousands of tokens later. With ``sanitize=True`` (or
``REPRO_SANITIZE=1``) the engine calls :func:`check_engine` after **every
request completion**, so a violated invariant raises at the step that
broke it, naming the page or slot involved.

The checks are pure host-side reads (numpy and dicts: no device work), so
sanitize mode costs O(pages + slots + index entries) per completed
request, not per token. The one device-side component, NaN/Inf probes on
the logits (or the fused head's finite flags) of every decode step and
final prefill chunk and on the activations of every other chunk, is
computed on the card beside each step's tokens and read back in the same
copy the engine already makes for them; :func:`check_finite_probe` raises
through :class:`SanitizerError` too.

Invariants (each has a seeded-violation test in
``tests/test_torch_sanitize.py``):

1. **Allocator conservation**: the free list and the refcount map
   partition page ids 1..P-1: no page in both, none in neither (a page in
   neither is a *leak*: unreachable until restart), no duplicate free-list
   entries, no refcount below 1, the null page never tracked.
2. **Refcount accounting**: each live page's refcount equals its visible
   holders: occurrences across running slots' page-table rows, plus the
   prefix index's holds, plus pending copy-on-write source pins.
3. **Slot/mask consistency**: running slots and the free-slot list
   partition ``range(num_slots)``; a free slot's page-table row is all
   null with ``seq_len`` 0; a running row is a null-free prefix with
   enough pages for its ``seq_len``, and the ``seq_len`` itself matches
   the sequence's lifecycle (``prefill_target`` mid-prefill,
   ``len(context) - 1`` once decoding: the last generated token's K/V is
   not yet written).
4. **PrefixIndex agreement**: the incrementally maintained ``_holds`` map
   equals a from-scratch recount of the index's entries, every interior
   node's child count matches its actual children, and every held page is
   live in the allocator with at least that many refs.

``SanitizerError`` subclasses ``AssertionError``: a violation is a broken
internal invariant, not a user error.
"""
from __future__ import annotations

import os
from collections import Counter
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:                       # pragma: no cover - typing only
    from ..serving.engine import ContinuousEngine
    from ..serving.kv_cache import PageAllocator
    from ..serving.scheduler import PrefixIndex

NULL_PAGE = 0


class SanitizerError(AssertionError):
    """A serving-engine invariant does not hold."""


def sanitize_enabled() -> bool:
    """Environment opt-in: ``REPRO_SANITIZE`` set to anything but ''/'0'."""
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


def _fail(invariant: str, detail: str) -> None:
    raise SanitizerError(f"[sanitize:{invariant}] {detail}")


# ----------------------------------------------------------- 1. conservation --

def check_allocator(allocator: "PageAllocator") -> None:
    """Free list ∪ refcounted pages partition {1..P-1}; nothing leaks."""
    ids = set(range(1, allocator.num_pages))
    free = allocator._free
    refs = allocator._refs
    if len(free) != len(set(free)):
        dupes = [p for p, n in Counter(free).items() if n > 1]
        _fail("conservation", f"duplicate free-list entries: {dupes}")
    both = set(free) & set(refs)
    if both:
        _fail("conservation", f"pages both free and refcounted: "
                              f"{sorted(both)}")
    leaked = ids - set(free) - set(refs)
    if leaked:
        _fail("conservation", f"leaked pages (neither free nor refcounted, "
                              f"unreachable until restart): {sorted(leaked)}")
    unknown = (set(free) | set(refs)) - ids
    if unknown:
        _fail("conservation", f"tracked ids outside 1..{allocator.num_pages - 1}"
                              f": {sorted(unknown)} (null page is reserved)")
    bad = {p: n for p, n in refs.items() if n < 1}
    if bad:
        _fail("conservation", f"refcount below 1: {bad}")


# ------------------------------------------------------------- 2. refcounts --

def check_refcounts(engine: "ContinuousEngine") -> None:
    """Every page's refcount == page-table occurrences + index holds + CoW
    source pins — nothing holds a page invisibly, nothing forgot a hold."""
    sched = engine.scheduler
    expected: Counter = Counter()
    for slot, seq in sched.running.items():
        row = sched.cache.page_table[slot]
        for p in row[row != NULL_PAGE]:
            expected[int(p)] += 1
        if seq.cow is not None:
            expected[seq.cow[0]] += 1   # pinned until the engine copies it
    if sched.prefix is not None:
        for p, n in sched.prefix._holds.items():
            expected[p] += n
    refs = sched.allocator._refs
    for p, n in expected.items():
        have = refs.get(p, 0)
        if have != n:
            _fail("refcount", f"page {p}: allocator holds {have} ref(s) but "
                              f"{n} visible holder(s) (page tables + prefix "
                              "holds + CoW pins)")
    orphans = {p: n for p, n in refs.items() if p not in expected}
    if orphans:
        _fail("refcount", f"refcounted pages with no visible holder "
                          f"(leak): {orphans}")


# ----------------------------------------------------------- 3. slots/masks --

def check_slots(engine: "ContinuousEngine") -> None:
    """Running ∪ free slots partition range(num_slots); rows and seq_lens
    agree with each sequence's lifecycle stage."""
    sched = engine.scheduler
    n_slots = engine.num_slots
    running = set(sched.running)
    free = sched._free_slots
    if len(free) != len(set(free)):
        _fail("slots", f"duplicate free-slot entries: "
                       f"{[s for s, n in Counter(free).items() if n > 1]}")
    both = running & set(free)
    if both:
        _fail("slots", f"slots both running and free: {sorted(both)}")
    lost = set(range(n_slots)) - running - set(free)
    if lost:
        _fail("slots", f"slots neither running nor free: {sorted(lost)}")
    for s in free:
        if sched.cache.page_table[s].any():
            _fail("slots", f"free slot {s} still owns pages "
                           f"{[int(p) for p in sched.cache.page_table[s] if p]}")
        if sched.cache.seq_lens[s] != 0:
            _fail("slots", f"free slot {s} has seq_len "
                           f"{int(sched.cache.seq_lens[s])} != 0")
    for s, seq in sched.running.items():
        row = sched.cache.page_table[s]
        n_pages = int((row != NULL_PAGE).sum())
        if row[:n_pages].min(initial=1) == NULL_PAGE or \
                row[n_pages:].any():
            _fail("slots", f"running slot {s} page row is not a null-free "
                           f"prefix: {row.tolist()}")
        seq_len = int(sched.cache.seq_lens[s])
        if n_pages * engine.page_size < seq_len:
            _fail("slots", f"running slot {s}: {n_pages} page(s) cover "
                           f"{n_pages * engine.page_size} tokens < seq_len "
                           f"{seq_len}")
        if seq.prefilled < seq.prefill_target:
            want = seq.prefill_target
            stage = "mid-prefill"
        else:
            # the newest generated token's K/V is never in the pages yet
            want = len(seq.request.prompt) + len(seq.generated) - 1
            stage = "decoding"
        if seq_len != want:
            _fail("slots", f"running slot {s} ({stage}): seq_len {seq_len} "
                           f"!= expected {want} (prompt "
                           f"{len(seq.request.prompt)}, generated "
                           f"{len(seq.generated)}, prefill_target "
                           f"{seq.prefill_target})")


# ---------------------------------------------------------- 4. prefix index --

def check_prefix(prefix: "PrefixIndex", allocator: "PageAllocator") -> None:
    """The incrementally maintained holds map and children counts equal a
    from-scratch recount; every held page is live in the allocator."""
    recount: Counter = Counter()
    entries = list(prefix._full.values())
    for bucket in prefix._partials.values():
        entries.extend(bucket.values())
    for e in entries:
        recount[e.page] += 1
    if dict(recount) != prefix._holds:
        drift = {p: (prefix._holds.get(p, 0), recount.get(p, 0))
                 for p in set(prefix._holds) | set(recount)
                 if prefix._holds.get(p, 0) != recount.get(p, 0)}
        _fail("prefix", f"holds map drifted from entries (page: "
                        f"(incremental, recount)): {drift}")
    children: Counter = Counter()
    for e in entries:
        if e.parent_key is not None:
            children[e.parent_key] += 1
    for key, e in prefix._full.items():
        if e.children != children.get(key, 0):
            _fail("prefix", f"entry {key!r} claims {e.children} children, "
                            f"recount says {children.get(key, 0)}")
    for p, n in prefix._holds.items():
        if allocator.ref_count(p) < n:
            _fail("prefix", f"index holds page {p} x{n} but allocator has "
                            f"only {allocator.ref_count(p)} ref(s)")


# ------------------------------------------------------------- all checks --

def check_engine(engine: "ContinuousEngine") -> None:
    """All host-side invariants, in dependency order (conservation first so
    later diagnostics can trust the allocator's own books)."""
    sched = engine.scheduler
    check_allocator(sched.allocator)
    check_refcounts(engine)
    check_slots(engine)
    if sched.prefix is not None:
        check_prefix(sched.prefix, sched.allocator)


def check_finite_probe(probe, where: str) -> None:
    """Raise on a failed NaN/Inf probe: the ``isfinite(...).all()`` flag a
    sanitizing engine computes on the card beside a step's tokens. The
    engine passes the flag as read back with those tokens (a host value),
    so checking it costs no synchronisation of its own; a tensor still on
    the card is read here."""
    if isinstance(probe, torch.Tensor):
        probe = probe.cpu()
    if not bool(np.asarray(probe)):
        _fail("finite", f"non-finite logits/activations detected at {where} "
                        "— NaN/Inf upstream of sampling")
