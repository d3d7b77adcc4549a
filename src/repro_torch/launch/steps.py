"""Train, prefill and serve step builders (the reference's
``launch/steps.py``).

A step runs on the CUDA device unless ``make_*_step`` is given another
``device``; without a card and without ``device="cpu"`` it raises.  The
prefill and serve steps run under ``torch.inference_mode``.  The train
step takes the gradient of ``api.loss_fn`` by autograd (on the card the
attention's gradient is the ``flash_attention`` backward kernel, the
SSD's the ``ssd_chunk`` backward kernel) and
updates the module's parameters in place.  The reference's input-spec
builders (``batch_specs``, ``param_specs``, ...) serve its dry run and
wait for that port (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.kernels.backends import resolve_device
from repro_torch.models import api
from repro_torch.optim import optimizers as opt

Params = Any


def model_batch(cfg: ModelConfig, batch: Dict[str, Any], device
                ) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as the model takes it, on
    ``device``: its floating inputs (an encoder-decoder's frames, a
    VLM's patches) in the model's dtype, as the reference's input specs
    declare them (the data pipeline makes them fp32, and fp32 frames
    would run a bf16 encoder in fp32)."""
    dtype = getattr(torch, cfg.dtype)
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        out[k] = t.to(device, dtype) if t.is_floating_point() \
            else t.to(device)
    return out


def make_train_step(cfg: ModelConfig,
                    optimizer: Optional[opt.Optimizer] = None,
                    clip_norm: float = 1.0, accum_steps: int = 1,
                    device=None) -> Callable:
    """One optimizer step: ``train_step(params, opt_state, batch) ->
    (params, opt_state, {"loss", "grad_norm"})``.

    ``params`` is the model module: its parameters are made trainable,
    their gradients taken by ``torch.autograd.grad`` (never stored in
    ``.grad``), clipped to ``clip_norm`` by global norm, and the
    optimizer's new values copied into them in place, so the returned
    module is the one given.  ``opt_state`` is the optimizer's state over
    ``dict(params.named_parameters())``, also updated in place.

    ``accum_steps > 1`` splits the global batch into microbatches run
    one after another (only one microbatch's activations live at a
    time) and averages their gradients in fp32, as the reference's
    ``lax.scan`` does: the update is the full-batch update up to fp
    reassociation."""
    optimizer = optimizer or opt.for_config(cfg)
    device = resolve_device(device)

    def grads_of(params: nn.Module, names, leaves, batch):
        loss = api.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach().float(), dict(zip(names, grads))

    def train_step(params: nn.Module, opt_state: Params,
                   batch: Dict[str, Any]):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        names, leaves = list(named), list(named.values())
        batch = model_batch(cfg, batch, device)
        if accum_steps == 1:
            loss, grads = grads_of(params, names, leaves, batch)
        else:
            micro = [{k: v.chunk(accum_steps)[i] for k, v in batch.items()}
                     for i in range(accum_steps)]
            loss = torch.zeros((), dtype=torch.float32, device=device)
            acc = {k: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for k, p in named.items()}
            for mb in micro:
                l, g = grads_of(params, names, leaves, mb)
                loss = loss + l
                for k, gk in g.items():
                    if gk is not None:
                        acc[k] += gk.float()
                del g
            loss = loss / accum_steps
            grads = {k: (acc[k] / accum_steps).to(p.dtype)
                     for k, p in named.items()}
            del acc
        grads, gnorm = opt.clip_by_global_norm(grads, clip_norm)
        with torch.no_grad():
            current = {k: p.detach() for k, p in named.items()}
            new_params, opt_state = optimizer.update(current, grads,
                                                     opt_state, loss)
            del grads
            for k, p in named.items():
                p.copy_(new_params[k])
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ModelConfig, device=None) -> Callable:
    """Forward logits over the full prompt (inference prefill)."""
    device = resolve_device(device)
    mod = api._mod(cfg)

    def prefill_step(params: nn.Module, batch: Dict[str, torch.Tensor]):
        with torch.inference_mode():
            tokens = batch["tokens"].to(device)
            if cfg.family == "encdec":
                return mod.forward(cfg, params, tokens,
                                   batch["frames"].to(device))
            if cfg.family == "vlm":
                return mod.forward(cfg, params, tokens,
                                   extra_embeds=batch["patches"].to(device))
            if cfg.family in ("moe", "hybrid"):
                logits, _aux = mod.forward(cfg, params, tokens)
                return logits
            return mod.forward(cfg, params, tokens)

    return prefill_step


def make_serve_step(cfg: ModelConfig, device=None) -> Callable:
    """One decode step for every slot of the batch."""
    device = resolve_device(device)

    def serve_step(params: nn.Module, cache: Dict[str, torch.Tensor],
                   token: torch.Tensor, pos: torch.Tensor):
        with torch.inference_mode():
            return api.serve_step(cfg, params, cache, token.to(device),
                                  pos.to(device))

    return serve_step


def step_for(cfg: ModelConfig, shape: ShapeSpec,
             optimizer: Optional[opt.Optimizer] = None,
             device=None) -> Callable:
    """The step that ``shape`` runs: train, prefill or decode."""
    if shape.kind == "train":
        return make_train_step(cfg, optimizer, device=device)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, device)
    return make_serve_step(cfg, device)
