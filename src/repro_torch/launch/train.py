"""The trainer: ``python -m repro_torch.launch.train --arch <id> [--smoke]
[--device cuda|cpu] [--ckpt-dir DIR --ckpt-every N] [...]``. Counterpart
of ``repro.launch.train``, with its defaults (B8, S128: the paper's Phase
1; LAMB at 1e-3; fp32 master weights), on one device: every arch of the
registry, the objective MLM where the arch is bidirectional, else causal,
on synthetic data from ``--seed`` (an encdec arch's batches also carry
frame embeddings for its encoder: ``DataConfig.frames``). With ``--ckpt-dir`` it checkpoints
every ``--ckpt-every`` steps and at the end, and resumes from the newest
checkpoint there (``resumed from step N``): the state is copied into the
tensors ``bundle.init`` built, and the data pipeline restarts at the
checkpoint's data step. ``REPRO_FUSED_BLOCKS=1`` routes the blocks through
the fused norm and GeLU kernels (off by default, as in JAX); the fused LAMB
kernels are ``RunConfig.fused_optimizer_kernel``, off here as in JAX's
trainer.
On the card each step after the second is one replay of the step captured
as a CUDA graph (``train.steps.StepGraph``), as JAX's trainer always runs
its jitted step; the last line gives the median step time after the
capture.
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..configs import RunConfig, ShapeConfig, get_config, smoke_config
from ..data import DataConfig, SyntheticPipeline
from ..models.convert import load_state_, state_to_jax
from ..models.transformer import period_length
from ..train.loop import LoopConfig, train_loop
from ..train.steps import build_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bert-large")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="lamb")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--no-master-weights", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train", microbatches=args.microbatches)
    run = RunConfig(arch=arch, shape=shape, optimizer=args.optimizer,
                    learning_rate=args.lr, zero1=False,
                    master_weights=not args.no_master_weights)
    bundle = build_train_step(run, device)
    objective = "mlm" if arch.bidirectional else "causal"
    data = SyntheticPipeline(DataConfig(
        vocab_size=arch.vocab_size, seq_len=args.seq,
        global_batch=args.batch, objective=objective, seed=args.seed,
        frames=(arch.enc_seq_len, arch.d_model)
        if arch.family == "encdec" else None))
    state = bundle.init(args.seed)
    start_step = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and ckpt.latest_step() is not None:
        restored = ckpt.restore()
        load_state_(state, restored["state"])
        start_step = restored["extra"].get("data_step", restored["step"])
        print(f"[train] resumed from step {start_step}")
    loop_cfg = LoopConfig(max_steps=args.steps, ckpt_every=args.ckpt_every,
                          log_every=max(args.steps // 20, 1))
    period = period_length(arch)
    out = train_loop(bundle.fn, state, data, loop_cfg,
                     start_step=start_step, ckpt=ckpt,
                     ckpt_tree=lambda s: state_to_jax(s, period))
    losses = [h["loss"] for h in out["history"]]
    if losses:
        # steps 1 and 2 are the warm-up and the capture on the card
        steady = [h["dt"] for h in out["history"][2:]]
        print(f"[train] {arch.name} on {device}: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} over {len(losses)} steps"
              + (f", median step {np.median(steady) * 1e3:.2f} ms from step "
                 f"3" if steady else "")
              + f" (stragglers: {out['monitor'].stragglers})")
    return out


if __name__ == "__main__":
    main()
