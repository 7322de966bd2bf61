"""Deterministic synthetic data pipeline (MLM + causal-LM), host-sharded.
The port's own copy of ``repro.data.pipeline`` (numpy only): for one seed
its batches are bit for bit those of the JAX package.

Real pre-training streams tokenized text; for a reproducible framework without
bundled corpora we generate structured synthetic token streams (Zipfian unigrams
with short-range Markov correlations so models have signal to learn) that are:

  * deterministic in (seed, step) — restart-safe: the pipeline state is just the
    step counter, checkpointed alongside the model;
  * host-sharded — each host materializes only its slice of the global batch
    (``host_id``/``num_hosts``), like a production loader on 1000+ nodes;
  * prefetchable — a background thread keeps ``prefetch`` batches ready.

Objectives:
  causal  : targets = inputs shifted left (decoder-only LMs)
  mlm     : BERT-style — 15% positions selected; 80% [MASK], 10% random, 10%
            kept; loss_mask marks selected positions (paper's Masked-LM task)

The port adds ``frames`` (JAX's pipeline has none, so JAX's trainer cannot
feed an encdec arch): ``(Senc, D)`` gives each batch ``frontend_embeddings``
[B, Senc, D] float32, standard normal from its own (seed, step, host)
stream, the stub frontend's frame embeddings of whisper's encoder. The
tokens, targets and masks are unchanged by it.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

MASK_TOKEN = 4
CLS_TOKEN = 2
SEP_TOKEN = 3


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    objective: str = "causal"      # causal | mlm
    seed: int = 1234
    host_id: int = 0
    num_hosts: int = 1
    mask_rate: float = 0.15
    zipf_a: float = 1.2
    markov_p: float = 0.35         # P(next token correlated with current)
    frames: Optional[Tuple[int, int]] = None   # (Senc, D): frame embeddings

    def __post_init__(self):
        # SeedSequence entropy (and default_rng in __init__) require this
        assert self.seed >= 0, "DataConfig.seed must be non-negative"


class SyntheticPipeline:
    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts
        rng = np.random.default_rng(cfg.seed)
        # fixed Zipf unigram table + a per-token "successor" table for structure
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / np.power(ranks, cfg.zipf_a)
        self._probs = probs / probs.sum()
        self._succ = rng.integers(5, cfg.vocab_size,
                                  size=cfg.vocab_size).astype(np.int32)

    # ------------------------------------------------------------------ core ---
    def _rng(self, step: int, domain: int) -> np.random.Generator:
        """Collision-free per-(seed, step, host) stream. Arithmetic mixes like
        ``seed*7 + step*13 + host_id`` alias across (step, host) pairs — e.g.
        (step=1, host=0) and (step=0, host=13) — handing different hosts (or
        adjacent steps) identical MLM masks. SeedSequence hashes the tuple
        coordinates independently; ``domain`` separates the token stream from
        the masking stream at the same coordinates."""
        cfg = self.cfg
        return np.random.default_rng(
            np.random.SeedSequence((cfg.seed, step, cfg.host_id, domain)))

    def _tokens_for(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = self._rng(step, 0)
        b, s = self.local_batch, cfg.seq_len
        base = rng.choice(cfg.vocab_size, size=(b, s), p=self._probs)
        corr = rng.random((b, s)) < cfg.markov_p
        toks = base.astype(np.int32)
        toks[:, 1:] = np.where(corr[:, 1:], self._succ[toks[:, :-1]],
                               toks[:, 1:])
        return np.clip(toks, 5, cfg.vocab_size - 1)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        toks = self._tokens_for(step)
        rng = self._rng(step, 1)
        if cfg.objective == "causal":
            inputs = toks
            targets = np.roll(toks, -1, axis=1)
            mask = np.ones_like(toks, np.float32)
            mask[:, -1] = 0.0
        elif cfg.objective == "mlm":
            inputs = toks.copy()
            targets = toks.copy()
            sel = rng.random(toks.shape) < cfg.mask_rate
            sel[:, 0] = False
            r = rng.random(toks.shape)
            inputs[sel & (r < 0.8)] = MASK_TOKEN
            rand_sel = sel & (r >= 0.8) & (r < 0.9)
            inputs[rand_sel] = rng.integers(
                5, cfg.vocab_size, size=int(rand_sel.sum()))
            mask = sel.astype(np.float32)
        else:
            raise ValueError(cfg.objective)
        out = {"tokens": inputs.astype(np.int32),
               "targets": targets.astype(np.int32),
               "loss_mask": mask}
        if cfg.frames is not None:
            out["frontend_embeddings"] = self._rng(step, 2).standard_normal(
                (self.local_batch, *cfg.frames), dtype=np.float32)
        return out

    # -------------------------------------------------------------- iterator ---
    def iterator(self, start_step: int = 0,
                 prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
        """Background-thread prefetching iterator, resumable at any step."""
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
