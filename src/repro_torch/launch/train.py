"""Training launcher (the reference's ``launch/train.py``).

    python -m repro_torch.launch.train --arch olmo-1b --smoke --steps 20
    python -m repro_torch.launch.train --arch olmo-1b --smoke --steps 4 --device cpu
    python -m repro_torch.launch.train --arch olmo-1b --layers 2 --steps 6

``--smoke`` uses the reduced same-family config; without it the full
published config, which ``--layers`` may cut in depth (its widths kept).
Checkpoints go to ``--ckpt-dir`` (a run resumes from the newest one
there) or, without it, to a fresh temporary directory, whose name the
launcher prints.  Runs on the CUDA device unless ``--device`` names
another.  ``--seq`` defaults to 128, raised to the config's SSD chunk
for the SSM and hybrid families (256 at full width); a ``--seq`` that is
not a multiple of the chunk raises.  ``--dp`` and ``--tp`` build the
mesh through ``launch/mesh.make_mesh`` over the devices of ``--device``'s
type: ``--dp 1 --tp 1`` trains on one device through the mesh, and a
mesh larger than the devices there are raises from ``make_mesh``.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import repro_torch.configs as C
from repro_torch.kernels.backends import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime.trainer import Trainer, TrainerConfig

DEFAULT_SEQ = 128


def train_seq(cfg, seq: Optional[int]) -> int:
    """The sequence length to train ``cfg`` at: ``seq``, or DEFAULT_SEQ
    rounded up to a multiple of the SSD chunk where ``cfg`` has SSM
    layers.  A ``seq`` those layers cannot split into whole chunks
    raises."""
    chunk = cfg.ssm.chunk if cfg.family in ("ssm", "hybrid") else 1
    if seq is None:
        return -(-DEFAULT_SEQ // chunk) * chunk
    if seq <= 0 or seq % chunk:
        raise ValueError(f"--seq {seq}: {cfg.name}'s SSD splits the sequence "
                         f"into chunks of {chunk}; give a positive multiple "
                         f"of {chunk}")
    return seq


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=C.ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep this many layers of the config (depth cut)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=None,
                    help=f"tokens a sequence (default {DEFAULT_SEQ}, or the "
                         f"SSD chunk if larger)")
    ap.add_argument("--ckpt-dir", type=str, default=None,
                    help="checkpoint directory, resumed from if it holds "
                         "one (default: a fresh temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    mesh = make_mesh(args.dp, args.tp,
                     device=resolve_device(args.device))

    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    seq = train_seq(cfg, args.seq)
    tcfg = TrainerConfig(total_steps=args.steps,
                         checkpoint_every=args.ckpt_every,
                         log_every=args.log_every,
                         global_batch=args.batch, seq_len=seq,
                         accum_steps=args.accum,
                         **({} if args.ckpt_dir is None else
                            {"checkpoint_dir": args.ckpt_dir}))
    print(f"checkpoints in {tcfg.checkpoint_dir}")
    trainer = Trainer(cfg, tcfg, mesh=mesh)
    state = trainer.run_with_recovery()
    print(f"finished at step {state.step}")
    for rec in trainer.metrics_log[-5:]:
        print(rec)
    return trainer


if __name__ == "__main__":
    main()
