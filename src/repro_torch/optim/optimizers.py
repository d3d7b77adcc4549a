"""Optimizers: AdamW (fp32 states and master copy) and Adafactor
(factored second moment, no master copy) -- the reference's
``optim/optimizers.py`` in PyTorch.

The reference's functional form is kept: ``init(params) -> state`` and
``update(params, grads, state, loss) -> (params, state)``, over a
name -> tensor dict of a module's parameters (``dict(
model.named_parameters())``), the state nested dicts of tensors on the
parameters' device, so ``checkpoint/store.py`` saves it as it is.
``torch.optim`` is not used: its AdamW takes the weight decay and eps
elsewhere.

The reference returns new arrays; here ``update`` writes the new
moments and master copy into the state's own tensors, which saves a
second copy of the optimizer state (16 bytes a parameter under AdamW)
while a step runs, and returns new parameter tensors.  Gradients that
are ``None`` (a parameter the loss does not reach) count as zeros, as
JAX's gradient of an unused leaf is.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]
OptState = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], OptState]
    update: Callable[[Params, Params, OptState, torch.Tensor],
                     Tuple[Params, OptState]]
    name: str = "opt"


# ---------------------------------------------------------------------- #
# gradient utilities
# ---------------------------------------------------------------------- #
def _grad(g, p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p) if g is None else g


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    leaves = [x for x in tree.values() if x is not None]
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


@torch.no_grad()
def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: None if g is None else (g.float() * scale).to(g.dtype)
            for k, g in grads.items()}, norm


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Schedule:
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def _lr_fn(lr: Union[Schedule, float]) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


# ---------------------------------------------------------------------- #
# AdamW
# ---------------------------------------------------------------------- #
def adamw(lr: Union[Schedule, float], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params: Params) -> OptState:
        dev = next(iter(params.values())).device
        with torch.no_grad():
            return {
                "step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in params.items()},
                "v": {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in params.items()},
                # fp32 master copy
                "master": {k: p.detach().float().clone()
                           for k, p in params.items()},
            }

    @torch.no_grad()
    def update(params: Params, grads: Params, state: OptState, _loss
               ) -> Tuple[Params, OptState]:
        step = state["step"] + 1
        t = step.float()
        lr_t = lr_fn(step)
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)
        new_params = {}
        for k, p in params.items():
            g = _grad(grads.get(k), p).float()
            m, v, pm = state["m"][k], state["v"][k], state["master"][k]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            mhat = m / c1
            vhat = v / c2
            pm.copy_(pm - lr_t * (mhat / (torch.sqrt(vhat) + eps)
                                  + weight_decay * pm))
            new_params[k] = pm.to(p.dtype, copy=True)
        state["step"] = step
        return new_params, state

    return Optimizer(init=init, update=update, name="adamw")


# ---------------------------------------------------------------------- #
# Adafactor (factored v, no first moment, no master copy)
# ---------------------------------------------------------------------- #
def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor(lr: Union[Schedule, float], decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params: Params) -> OptState:
        def per_param(p):
            z = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        dev = next(iter(params.values())).device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "v": {k: per_param(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(params: Params, grads: Params, state: OptState, _loss
               ) -> Tuple[Params, OptState]:
        step = state["step"] + 1
        t = step.float()
        lr_t = lr_fn(step)
        beta = 1.0 - torch.pow(t, -decay)
        new_params = {}
        for k, p in params.items():
            g = _grad(grads.get(k), p).float()
            v = state["v"][k]
            g2 = g * g + eps
            if _factored(p.shape):
                v["vr"].copy_(beta * v["vr"]
                              + (1 - beta) * torch.mean(g2, dim=-1))
                v["vc"].copy_(beta * v["vc"]
                              + (1 - beta) * torch.mean(g2, dim=-2))
                vr, vc = v["vr"], v["vc"]
                denom = torch.sqrt(
                    (vr / torch.mean(vr, dim=-1, keepdim=True))[..., None]
                    * vc[..., None, :])
                u = g / torch.clamp(denom, min=1e-30)
            else:
                v["v"].copy_(beta * v["v"] + (1 - beta) * g2)
                u = g / torch.sqrt(v["v"])
            # update clipping (Adafactor's RMS rule)
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            pf = p.float()
            new_params[k] = (pf - lr_t * (u + weight_decay * pf)).to(p.dtype)
        state["step"] = step
        return new_params, state

    return Optimizer(init=init, update=update, name="adafactor")


def for_config(cfg, base_lr: float = 3e-4, warmup: int = 2000,
               total: int = 100_000) -> Optimizer:
    """AdamW below ~100 B params, Adafactor above (memory budget)."""
    from repro_torch.configs.base import param_count
    sched = cosine_schedule(base_lr, warmup, total)
    if param_count(cfg) > 1e11:
        return adafactor(sched)
    return adamw(sched)
