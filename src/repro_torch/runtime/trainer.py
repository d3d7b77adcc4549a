"""Fault-tolerant training loop (the reference's ``runtime/trainer.py``).

Wires together: sharded data -> train step -> async checkpointing ->
heartbeat/straggler monitoring -> crash recovery (restore from the last
complete checkpoint).

The loop takes a mesh, as the reference's does: by default
``make_mesh(1, 1)`` over its device, the CUDA device unless ``device``
names another (``device="cpu"`` runs every kernel's plain version).
Around the step it sets the mesh and ``rules_for("train")`` as the
logical ones (``sharding/logical.py``), and it places the parameters and
the optimizer state by ``param_shardings`` (each tensor whole on the
mesh's one device).  A mesh of more devices raises: the port's step runs
on one.  A state's parameters are the model module; a checkpoint holds
``{"params": <name -> tensor dict>, "opt_state": ...}`` through
``checkpoint.CheckpointManager`` and is restored onto the loop's
device.

Crash recovery retries a non-finite loss (``FloatingPointError``) and
other ``RuntimeError``s, as the reference does, but never a
``KernelError``: a kernel that does not build or launch fails the run at
once instead of being retried.
"""
from __future__ import annotations

import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, ShardedSyntheticDataset
from repro_torch.kernels.backends import resolve_device
from repro_torch.kernels.build import KernelError
from repro_torch.launch import sharding as S
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import api
from repro_torch.optim import optimizers as opt
from repro_torch.runtime.health import HeartbeatMonitor
from repro_torch.sharding import logical

Params = Any


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    # a fresh directory under the temp dir (TMPDIR) unless one is given:
    # a shared default would resume another run's checkpoints
    checkpoint_dir: str = field(default_factory=lambda: tempfile.mkdtemp(
        prefix="repro_torch_ckpt_"))
    keep_checkpoints: int = 3
    log_every: int = 10
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    async_checkpoint: bool = True
    accum_steps: int = 1        # gradient-accumulation microbatches


@dataclass
class TrainState:
    params: nn.Module
    opt_state: Params
    step: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 device=None, optimizer: Optional[opt.Optimizer] = None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.tcfg = tcfg
        if mesh is None:
            mesh = make_mesh(1, 1, device=resolve_device(device))
        elif device is not None:
            raise ValueError("give the Trainer a device or a mesh, not both")
        if mesh.abstract or mesh.size != 1:
            raise NotImplementedError(
                f"a mesh of {mesh.size} devices ({mesh.shape}): the port's "
                f"step runs on one device")
        self.mesh = mesh
        self.device = mesh.devices[0]
        self.optimizer = optimizer or opt.for_config(cfg)
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir,
                                      keep=tcfg.keep_checkpoints)
        self.monitor = HeartbeatMonitor(n_hosts=1)
        self.data = ShardedSyntheticDataset(DataConfig(
            vocab=cfg.vocab, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed,
            n_patches=cfg.n_patches if cfg.family == "vlm" else 0,
            enc_frames=cfg.enc_frames if cfg.family == "encdec" else 0,
            d_model=cfg.d_model))
        self._step_fn = None
        self.metrics_log: list = []
        #: seconds each ``_save`` held the loop (an async save: its
        #: snapshot to the host and the wait for the save before it; the
        #: write itself is ``self.ckpt.write_seconds``)
        self.save_seconds: list = []

    # ------------------------------------------------------------------ #
    def init_state(self, seed: int = 0) -> TrainState:
        params = api.init(self.cfg,
                          torch.Generator(self.device).manual_seed(seed),
                          self.device)
        params = S.place(params, S.param_shardings(params, self.mesh))
        opt_state = self.optimizer.init(dict(params.named_parameters()))
        opt_state = S.place(opt_state,
                            S.param_shardings(opt_state, self.mesh))
        return TrainState(params=params, opt_state=opt_state, step=0)

    def _compiled_step(self):
        if self._step_fn is None:
            self._step_fn = ST.make_train_step(
                self.cfg, self.optimizer, accum_steps=self.tcfg.accum_steps,
                device=self.device)
        return self._step_fn

    def _device_batch(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
        """The pipeline's batch as the step takes it: frames and patches
        in the model's dtype (the reference's trainer feeds them in fp32,
        its input specs in the model's dtype)."""
        return ST.model_batch(self.cfg, batch, self.device)

    @staticmethod
    def _tree(state: TrainState) -> Dict[str, Params]:
        return {"params": {k: p.detach() for k, p in
                           state.params.named_parameters()},
                "opt_state": state.opt_state}

    # ------------------------------------------------------------------ #
    def restore_or_init(self, step: Optional[int] = None) -> TrainState:
        """The newest complete checkpoint (or the one at ``step``) on
        this loop's device, else a fresh state."""
        state = self.init_state()
        if step is None:
            step = self.ckpt.latest_step()
            if step is None:
                return state
        restored, got = self.ckpt.restore(self._tree(state), self.device,
                                          step)
        with torch.no_grad():
            for k, p in state.params.named_parameters():
                p.copy_(restored["params"][k])
        opt_state = S.place(restored["opt_state"], S.param_shardings(
            restored["opt_state"], self.mesh))
        return TrainState(params=state.params, opt_state=opt_state,
                          step=got)

    def train(self, state: Optional[TrainState] = None,
              on_step: Optional[Callable[[int, Dict], None]] = None
              ) -> TrainState:
        state = state or self.restore_or_init()
        step_fn = self._compiled_step()
        host = 0
        saved = None
        logical.set_mesh(self.mesh)
        logical.set_rules(S.rules_for("train"))
        try:
            while state.step < self.tcfg.total_steps:
                t0 = time.time()
                batch = self._device_batch(
                    self.data.global_batch_at(state.step))
                params, opt_state, metrics = step_fn(
                    state.params, state.opt_state, batch)
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(
                        f"non-finite loss at step {state.step}")
                state = TrainState(params, opt_state, state.step + 1)
                dt = time.time() - t0
                self.monitor.heartbeat(host, state.step, dt)
                if state.step % self.tcfg.log_every == 0:
                    rec = {"step": state.step, "loss": loss,
                           "grad_norm": float(metrics["grad_norm"]),
                           "s_per_step": dt}
                    self.metrics_log.append(rec)
                    if on_step:
                        on_step(state.step, rec)
                if state.step % self.tcfg.checkpoint_every == 0:
                    self._save(state)
                    saved = state.step
        finally:
            logical.set_mesh(None)
            logical.set_rules(None)
            self.ckpt.wait()
        if saved != state.step:     # the last step's state, once
            self._save(state)
        self.ckpt.wait()
        return state

    def _save(self, state: TrainState) -> None:
        t0 = time.perf_counter()
        if self.tcfg.async_checkpoint:
            self.ckpt.save_async(state.step, self._tree(state))
        else:
            self.ckpt.save(state.step, self._tree(state))
        self.save_seconds.append(time.perf_counter() - t0)

    # ------------------------------------------------------------------ #
    def run_with_recovery(self, max_restarts: int = 2) -> TrainState:
        """Crash-tolerant outer loop: on a step failure, reload the
        newest complete checkpoint and continue.  A ``KernelError`` is
        re-raised at once."""
        attempts = 0
        while True:
            try:
                return self.train()
            except KernelError:
                raise
            except (FloatingPointError, RuntimeError) as ex:
                attempts += 1
                if attempts > max_restarts:
                    raise
                print(f"[trainer] step failure ({ex}); restoring from "
                      f"checkpoint (attempt {attempts})")
                self._step_fn = None
