"""Training launcher: the Trainer on one device. Counterpart of
``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch internlm2-1.8b
    python -m repro_torch.launch.train --arch deepseek-7b --smoke \
        --device cpu --steps 3

The flags are ``repro``'s plus ``--device`` (default ``cuda``: the launcher
fails where there is no card unless told ``--device cpu``). Only
``--mesh none`` is ported (a 2D mesh is ROADMAP A14), and ``--ckpt-dir``
raises until checkpointing is ported (A15). ``--smoke`` trains the reduced
config on a 4 x 128 shape in f32 without remat, as ``repro``'s. Every step
prints a ``step N loss ...`` line. The tensor-parallel training step on a
ring of processes is ``repro_torch.train.step.make_train_step`` on an ``LM``
built with a group (``chip_smoke.py`` phase 9).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

from repro_torch.configs import SHAPES_BY_NAME, ShapeConfig, get_arch
from repro_torch.core.backends import available_backends
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import build_model
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.runtime import TPConfig, runtime_for
from repro_torch.train import Trainer, TrainerConfig


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "debug", "single", "multi"])
    ap.add_argument("--tp-mode", default="auto",
                    choices=available_backends())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny shape (CPU-runnable)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Optional[List[str]] = None) -> Trainer:
    args = parser().parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError(f"--mesh {args.mesh}: meshes are not "
                                  "ported yet (ROADMAP A14); use --mesh none")
    cfg = get_arch(args.arch)
    rt = dataclasses.replace(runtime_for(cfg),
                             tp=TPConfig(mode=args.tp_mode))
    if args.smoke:
        cfg = cfg.smoke()
        shape = ShapeConfig("smoke_train", 128, 4, "train")
        rt = dataclasses.replace(rt, compute_dtype="float32", remat=False,
                                 loss_chunk=64)
    else:
        shape = SHAPES_BY_NAME[args.shape]
    model = build_model(cfg, rt, device=args.device, seed=args.seed)
    opt = make_optimizer(cfg.optimizer,
                         cosine_schedule(args.lr, args.warmup, args.steps))
    tc = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, log_every=1,
                       microbatches=args.microbatches)
    trainer = Trainer(model, opt, cfg, shape, rt, tc, DataConfig(args.seed))
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
