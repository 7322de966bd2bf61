"""The training loop with a step-time monitor and checkpoint/restart.
Counterpart of ``repro.train.loop`` (``LoopConfig``, ``StepMonitor``,
``train_loop``): every ``ckpt_every`` steps an asynchronous save (the
state copied to host memory before the next step is queued, written in a
background thread) with the data step to resume from, and a final save at
``max_steps``; ``start_step`` resumes the data pipeline where a restored
checkpoint left it. The manager (which keeps the newest ``keep``) is the
caller's, as is ``ckpt_tree``: the state -> the tree a checkpoint holds.
The launcher, which knows the arch, passes JAX's layout
(``models.convert.state_to_jax`` at the stack's period); JAX's
``LoopConfig.ckpt_dir``, which makes a manager inside the loop, has no
counterpart.

Metrics stay on the device for one step: reading the current step's
metrics (``float`` of a CUDA tensor) would make the host wait for the card
before the next step is queued. Each step instead reads the previous
step's metrics after dispatching its own, so the card always has work
queued behind the wait, while ``dt`` still measures the card's step time
(attributed one step late).

With a ``group`` (a data group, or any group of a training mesh) only the
mesh's rank 0 logs and keeps the history (the metrics are the whole
batch's on every rank); the step is the same.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..data import SyntheticPipeline


@dataclasses.dataclass
class LoopConfig:
    max_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    step_deadline_s: float = 0.0    # watchdog: abort past this (0 = off)
    straggler_factor: float = 3.0   # a straggler: step > factor * EWMA
    ewma_alpha: float = 0.1


class StepMonitor:
    """EWMA step-time tracker + hard-deadline watchdog."""

    def __init__(self, cfg: LoopConfig, on_deadline: Callable[[], None]):
        self.cfg = cfg
        self.ewma: Optional[float] = None
        self.stragglers = 0
        self._deadline_timer: Optional[threading.Timer] = None
        self._on_deadline = on_deadline

    def step_started(self) -> None:
        if self.cfg.step_deadline_s > 0:
            self._deadline_timer = threading.Timer(
                self.cfg.step_deadline_s, self._on_deadline)
            self._deadline_timer.daemon = True
            self._deadline_timer.start()

    def step_finished(self, dt: float) -> bool:
        """-> True if this step was a straggler."""
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
            self._deadline_timer = None
        straggler = (self.ewma is not None
                     and dt > self.cfg.straggler_factor * self.ewma)
        a = self.cfg.ewma_alpha
        self.ewma = dt if self.ewma is None else (1 - a) * self.ewma + a * dt
        if straggler:
            self.stragglers += 1
        return straggler


def train_loop(step_fn: Callable, state: Any, data: SyntheticPipeline,
               cfg: LoopConfig, start_step: int = 0,
               ckpt: Optional[CheckpointManager] = None,
               ckpt_tree: Callable[[Any], Any] = lambda s: s,
               log: Callable[[str], None] = print,
               group=None) -> Dict[str, Any]:
    """Run (or resume from ``start_step``) training; returns ``{"state",
    "history", "monitor"}`` with one history entry (plain floats) per
    step (none on a rank other than the mesh's rank 0 when ``group`` is
    given: it logs nothing).
    ``ckpt`` saves ``ckpt_tree(state)`` every ``cfg.ckpt_every`` steps and
    at the end."""
    lead = group is None or dist.get_rank() == 0
    if not lead:
        log = lambda s: None  # noqa: E731

    def _abort():
        log("[watchdog] step deadline exceeded; aborting for a scheduler "
            "restart")
        os._exit(42)

    monitor = StepMonitor(cfg, _abort)
    history = []
    pending = []                        # (history index, device metrics)

    def _materialize(upto=None):
        while pending and (upto is None or pending[0][0] <= upto):
            idx, m = pending.pop(0)
            history[idx].update({k: float(v) for k, v in m.items()})

    it = data.iterator(start_step=start_step)
    for step in range(start_step, cfg.max_steps):
        batch = next(it)
        monitor.step_started()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        history.append({"step": step, "dt": 0.0})
        pending.append((len(history) - 1, metrics))
        _materialize(upto=len(history) - 2)   # pipeline-depth-1 sync
        dt = time.perf_counter() - t0
        history[-1]["dt"] = dt
        straggler = monitor.step_finished(dt)
        if straggler:
            log(f"[monitor] step {step} straggled: {dt:.3f}s vs EWMA "
                f"{monitor.ewma:.3f}s")
        if step % cfg.log_every == 0 or straggler:
            # log the newest completed step: flushing the in-flight one
            # would leave the next step nothing to wait on
            if len(history) == 1:
                _materialize()          # very first line: one-time sync
            done = history[-1] if len(history) == 1 else history[-2]
            log(f"step {done['step']:5d} "
                f"loss={done.get('loss', float('nan')):.4f} "
                f"acc={done.get('accuracy', 0.0):.3f} "
                f"{done['dt'] * 1e3:.0f}ms")
        if ckpt and (step + 1) % cfg.ckpt_every == 0:
            ckpt.save_async(step + 1, ckpt_tree(state),
                            extra={"data_step": step + 1})
    _materialize()
    if ckpt:
        ckpt.wait()
        ckpt.save(cfg.max_steps, ckpt_tree(state),
                  extra={"data_step": cfg.max_steps})
    return {"state": state, "history": history if lead else [],
            "monitor": monitor}
