"""Training launcher: the Trainer on one device, or on JAX's 2 x 4 debug
mesh. Counterpart of ``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch internlm2-1.8b
    python -m repro_torch.launch.train --arch deepseek-7b --smoke \
        --device cpu --steps 3
    python -m repro_torch.launch.train --arch deepseek-7b --smoke \
        --mesh debug --device cpu --steps 3

The flags are ``repro``'s plus ``--device`` (default ``cuda``: the launcher
fails where there is no card unless told ``--device cpu``). ``--mesh debug``
spawns 8 local ranks (:func:`repro_torch.launch.ranks.run_ranks`; gloo where
they share a card) on a ``data`` 2 x ``model`` 4 mesh
(:func:`repro_torch.launch.mesh.make_debug_mesh`): each replica trains on
its half of every global batch, the grads are summed over the replicas,
and rank 0 prints the lines; every ``--tp-mode`` runs there, the default
``auto`` as DTensor placements over each replica's TP group (dense
attention archs; the others raise under it, ROADMAP A5 (b)). ``--mesh
single|multi`` raise (they need a multi-host launcher). ``--ckpt-dir DIR``
checkpoints every ``--ckpt-every`` steps (and on a straggler or
preemption) and resumes from DIR's latest step: rerunning the same command
with more ``--steps`` goes on where the last run stopped, on one device or
under ``--mesh debug`` (each rank restores its shards; rank 0 writes the
whole arrays). Each arch trains with its config's optimizer (arctic-480b:
adafactor). ``--smoke`` trains the reduced config on a 4 x 128 shape in
f32 without remat, as ``repro``'s. Every step prints a ``step N loss ...``
line; ``--history PATH`` also writes the steps' losses unrounded as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional, Union

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
    ap.add_argument("--history", default="",
                    help="write every step's loss (rank 0's) as JSON here")
    return ap


@dataclasses.dataclass
class MeshRun:
    """What ``--mesh debug`` returns: rank 0's step history and every
    rank's."""
    history: List[dict]
    ranks: List[List[dict]]


def _setup(args):
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
    return cfg, rt, shape


def _trainer(args, group=None, log: bool = True) -> Trainer:
    cfg, rt, shape = _setup(args)
    model = build_model(cfg, rt, device=args.device, seed=args.seed,
                        group=group)
    opt = make_optimizer(cfg.optimizer,
                         cosine_schedule(args.lr, args.warmup, args.steps))
    tc = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every,
                       log_every=1 if log else 0,
                       microbatches=args.microbatches)
    return Trainer(model, opt, cfg, shape, rt, tc, DataConfig(args.seed))


def _debug_rank(world, args) -> List[dict]:
    """One rank of ``--mesh debug``: the Trainer on the debug mesh; rank 0
    prints the step lines."""
    from repro_torch.launch.mesh import make_debug_mesh

    trainer = _trainer(args, make_debug_mesh(world), log=world.rank == 0)
    trainer.run()
    return trainer.history


def main(argv: Optional[List[str]] = None) -> Union[Trainer, MeshRun]:
    args = parser().parse_args(argv)
    if args.mesh in ("single", "multi"):
        from repro_torch.launch.mesh import make_production_mesh

        make_production_mesh(multi_pod=args.mesh == "multi")
    if args.mesh == "debug":
        from repro_torch.launch.mesh import DEBUG_SHAPE
        from repro_torch.launch.ranks import run_ranks
        from repro_torch.runtime import resolve_device

        resolve_device(args.device)       # no card: fail before spawning
        ranks = run_ranks(_debug_rank, DEBUG_SHAPE[0] * DEBUG_SHAPE[1], args,
                          device=args.device, timeout=3600)
        _write_history(args.history, ranks[0])
        return MeshRun(history=ranks[0], ranks=ranks)
    trainer = _trainer(args)
    trainer.run()
    _write_history(args.history, trainer.history)
    return trainer


def _write_history(path: str, history: List[dict]) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(history, f)


if __name__ == "__main__":
    main()
