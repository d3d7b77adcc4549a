"""End-to-end training driver with fault tolerance, on the PyTorch
port: trains an LM with the full runtime stack (sharded data -> train
step with the card's attention kernels forward and backward -> async
checkpoints -> crash recovery), then kills and resumes it to prove
restart correctness.

Default is a fast smoke config; ``--full-100m`` trains a ~110M-param
model (slow on the CPU -- meant for the card).  Runs on the CUDA device
unless ``--device`` names another.

    PYTHONPATH=src python examples/torch/train_lm.py --steps 30 [--device cpu]
"""
import argparse
import dataclasses
import shutil
import tempfile

import repro_torch.configs as C
from repro_torch.configs.base import ModelConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def config_100m() -> ModelConfig:
    """~110M-param dense transformer."""
    return dataclasses.replace(
        C.get("olmo-1b"), name="lm-100m", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab=32768, head_dim=64)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=C.ARCH_IDS, default="olmo-1b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()

    cfg = config_100m() if args.full_100m else C.get_smoke(args.arch)
    workdir = tempfile.mkdtemp(prefix="repro_train_")
    try:
        tcfg = TrainerConfig(total_steps=args.steps,
                             checkpoint_every=max(args.steps // 3, 1),
                             checkpoint_dir=workdir, log_every=5,
                             seq_len=128, global_batch=8,
                             async_checkpoint=True)

        # ---- phase 1: train the first 2/3, then "crash"
        t1 = Trainer(cfg, tcfg, device=args.device)
        t1.tcfg.total_steps = 2 * args.steps // 3
        state = t1.run_with_recovery()
        print(f"phase 1 stopped at step {state.step} "
              f"(loss {t1.metrics_log[-1]['loss']:.3f})")

        # ---- phase 2: a fresh process restores and finishes
        t2 = Trainer(cfg, dataclasses.replace(tcfg, total_steps=args.steps),
                     device=args.device)
        state = t2.run_with_recovery()
        print(f"phase 2 resumed and finished at step {state.step}")
        for rec in t2.metrics_log[-3:]:
            print(" ", rec)
        assert state.step == args.steps
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
