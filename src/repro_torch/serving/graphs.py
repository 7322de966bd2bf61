"""The multi-step decode loop's static buffers and captured iteration.

Counterpart of the jitted ``lax.while_loop`` dispatch of the JAX engine
(``repro.serving.engine.ContinuousEngine._decode_multi_fn``): the port runs
one loop iteration (``models.transformer.paged_decode_loop_step``) over
buffers whose addresses never change, so that on the card the iteration is
captured once per step variant as a ``torch.cuda.CUDAGraph`` and each
dispatch of N iterations is ``k`` replays of it, with no Python-issued
launch and no host read in between. The host predicts every exit but an EOS
(``k`` is the least of N, the slots' token budgets and their page room);
an iteration after an EOS is a no-op on the card (the loop's ``live`` flag).

One int32 buffer holds everything a dispatch moves, so a dispatch makes one
host-to-device copy (from a pinned twin, not a synchronisation) and one
device-to-host copy (its one synchronisation)::

    seeds (int64 view) | temps, top_p (float32 views) | top_k | page_table
    | active | budget | page_limit | eos_ids | tokens | lens | reasons
    | i | ok | exits | buf [N, S]
    \\____________________ staged per dispatch ____________/
                                              \\____ read back _________/

The first dispatch of a variant runs its first iteration eagerly on a side
stream (the warm-up: library builds, ``ctypes`` bindings and first-use
``cudaFuncSetAttribute`` calls happen there, outside any capture), then
captures the iteration into one memory pool shared by every variant's
graph, then replays the rest. A graph holds the addresses of the buffers
and of the page pools (the paged kernels' TMA descriptors are encoded at
capture from the pools' base addresses), so a dispatch whose pools have
moved recaptures, and the engine's ``trace_stats()["excess"]`` counts it.

The capture and the launch accounting are ``repro_torch.graphs``'s:
a replay adds the launches its capture counted, so ``LAUNCHES`` stays
exact. ``replays`` counts graph replays. On the CPU there is no graph:
``run`` calls the iteration ``k`` times eagerly, on the same buffers.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .. import graphs
from ..graphs import Captured


class DecodeLoop:
    """Static buffers of the multi-step loop for ``num_slots`` slots,
    page-table rows of ``max_pages`` and a horizon of ``horizon``
    iterations, on ``device``; on a CUDA device also the captured graphs."""

    def __init__(self, num_slots: int, max_pages: int, horizon: int,
                 device: torch.device):
        s, n = num_slots, horizon
        self.horizon, self.device = horizon, device
        sizes = [("seeds", 2 * s), ("temps", s), ("top_p", s), ("top_k", s),
                 ("page_table", s * max_pages), ("active", s),
                 ("budget", s), ("page_limit", s), ("eos_ids", s),
                 ("tokens", s), ("lens", s), ("reasons", s), ("i", 1),
                 ("ok", 1), ("exits", s), ("buf", n * s)]
        off, spans = 0, {}
        for name, size in sizes:
            spans[name] = (off, off + size)
            off += size
        self._staged = spans["ok"][1]           # words copied to the card
        self._read_from = spans["i"][0]         # words read back
        cuda = device.type == "cuda"
        self._host = torch.zeros((off,), dtype=torch.int32,
                                 pin_memory=cuda)
        self.buffer = (torch.zeros((off,), dtype=torch.int32, device=device)
                       if cuda else self._host)
        shapes = {"page_table": (s, max_pages), "buf": (n, s), "i": (),
                  "ok": ()}
        views = {"seeds": torch.int64, "temps": torch.float32,
                 "top_p": torch.float32}

        def cut(t, name):
            a, b = spans[name]
            v = t[a:b]
            if name in views:
                v = v.view(views[name])
            return v.view(shapes.get(name, (-1,)))
        # host views (numpy) for staging; device views for the iteration
        self._stage = {k: cut(self._host, k).numpy() for k in spans}
        self.carry = {k: cut(self.buffer, k) for k in spans}
        self.graphs: Dict[tuple, Captured] = {}
        self.captures = 0
        self.replays = 0
        self.pool_bytes = 0
        self._pool = None
        self._stream = None

    # ------------------------------------------------------------- staging --
    def stage(self, *, page_table, seq_lens, tokens, active, budget,
              page_limit, eos_ids, seeds, temps, top_ks, top_ps) -> None:
        """Write one dispatch's inputs and the loop's initial carry (i 0,
        no reasons, probe ok) and copy them to the device buffer."""
        st = self._stage
        st["seeds"][:] = seeds
        st["temps"][:] = temps
        st["top_p"][:] = top_ps
        st["top_k"][:] = top_ks
        st["page_table"][:] = page_table
        st["active"][:] = active
        st["budget"][:] = budget
        st["page_limit"][:] = page_limit
        st["eos_ids"][:] = eos_ids
        st["tokens"][:] = tokens
        st["lens"][:] = seq_lens
        st["reasons"][:] = 0
        st["i"][...] = 0
        st["ok"][...] = 1
        if self.buffer is not self._host:
            self.buffer[:self._staged].copy_(self._host[:self._staged],
                                             non_blocking=True)

    # --------------------------------------------------------------- running --
    def run(self, key: tuple, k: int, step: Callable[[], None],
            pools: Tuple[int, ...]) -> bool:
        """``k`` iterations of ``step`` (the loop iteration over
        ``self.carry``), for the step variant ``key``. On the card: replays
        of its graph, captured first if the variant has none or its pools
        moved (``pools``: their addresses). Returns whether it captured."""
        if self.device.type != "cuda":
            for _ in range(k):
                step()
            return False
        entry = self.graphs.get(key)
        captured = entry is None or entry.pools != pools
        if captured:
            graphs.warm_up(step, self._side_stream())   # iteration 0
            k -= 1
            entry = self.graphs[key] = self._capture(step, pools)
        self.replay(entry, k)
        return captured

    def replay(self, entry: Captured, k: int) -> None:
        """``k`` replays of a captured iteration, each counted as the
        launches it captured."""
        graphs.replay(entry, k)
        self.replays += k

    def read(self) -> torch.Tensor:
        """The read-back span (i, ok, exits, buf) as one tensor on the
        device; the engine copies it to the host in its one
        synchronisation."""
        return self.buffer[self._read_from:]

    def unpack(self, words: np.ndarray) -> Tuple[int, bool, np.ndarray,
                                                  np.ndarray]:
        """The host copy of ``read()`` -> (iterations run, probe ok, exit
        bits [S], emitted tokens [N, S])."""
        s = self._stage["exits"].shape[0]
        return (int(words[0]), bool(words[1]), words[2:2 + s],
                words[2 + s:].reshape(self.horizon, s))

    # ------------------------------------------------------------- capture --
    def _side_stream(self) -> "torch.cuda.Stream":
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _capture(self, step: Callable[[], None],
                 pools: Tuple[int, ...]) -> Captured:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        entry, added = graphs.capture(step, pool=self._pool,
                                      stream=self._side_stream(),
                                      device=self.device, pools=pools)
        self.captures += 1
        self.pool_bytes += added
        return entry
