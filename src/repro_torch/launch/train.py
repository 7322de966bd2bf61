"""The trainer: ``python -m repro_torch.launch.train --arch bert-large
[--smoke] [--device cuda|cpu] [...]``. Counterpart of
``repro.launch.train``, with its defaults (B8, S128: the paper's Phase 1;
LAMB at 1e-3; fp32 master weights), on one device. Synthetic MLM data from
``--seed``. ``REPRO_FUSED_BLOCKS=1`` routes the blocks through the fused
norm and GeLU kernels (off by default, as in JAX); the fused LAMB kernels
are ``RunConfig.fused_optimizer_kernel``, off here as in JAX's trainer.
"""
from __future__ import annotations

import argparse

from .. import resolve_device
from ..configs import RunConfig, ShapeConfig, get_config, smoke_config
from ..data import DataConfig, SyntheticPipeline
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
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpointing: not ported (raises)")
    ap.add_argument("--no-master-weights", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    if args.arch != "bert-large":
        raise NotImplementedError(f"training of {args.arch} not ported")
    if args.ckpt_dir:
        raise NotImplementedError("--ckpt-dir: checkpointing not ported")
    device = resolve_device(args.device)
    arch = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train", microbatches=args.microbatches)
    run = RunConfig(arch=arch, shape=shape, optimizer=args.optimizer,
                    learning_rate=args.lr, zero1=False,
                    master_weights=not args.no_master_weights)
    bundle = build_train_step(run, device)
    data = SyntheticPipeline(DataConfig(
        vocab_size=arch.vocab_size, seq_len=args.seq,
        global_batch=args.batch, objective="mlm", seed=args.seed))
    state = bundle.init(args.seed)
    loop_cfg = LoopConfig(max_steps=args.steps,
                          log_every=max(args.steps // 20, 1))
    out = train_loop(bundle.fn, state, data, loop_cfg)
    losses = [h["loss"] for h in out["history"]]
    if losses:
        print(f"[train] {arch.name} on {device}: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} over {len(losses)} steps (stragglers: "
              f"{out['monitor'].stragglers})")
    return out


if __name__ == "__main__":
    main()
