"""Train, prefill and serve step builders and the inputs' specs (the
reference's ``launch/steps.py``).

A step runs on the CUDA device unless ``make_*_step`` is given another
``device``; without a card and without ``device="cpu"`` it raises.  The
prefill and serve steps run under ``torch.inference_mode`` (under
``torch.no_grad`` when given DTensors: DTensor fails some ops under
inference mode).  The train
step takes the gradient of ``api.loss_fn`` by autograd (on the card the
attention's gradient is the ``flash_attention`` backward kernel, the
SSD's the ``ssd_chunk`` backward kernel) and
updates the module's parameters in place.

``input_specs(cfg, shape)`` gives stand-ins for every input of the step
a shape runs, as tensors on the ``meta`` device (shapes and dtypes, no
storage: the port's counterpart of the reference's
``ShapeDtypeStruct``s); nothing is allocated.  A step built with
``device="meta"`` runs on them (``launch/dryrun.py``).
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
from repro_torch.sharding.logical import is_sharded

Params = Any


META = torch.device("meta")


# ---------------------------------------------------------------------- #
# input specs (meta tensors; nothing is allocated)
# ---------------------------------------------------------------------- #
def batch_specs(cfg: ModelConfig, shape: ShapeSpec
                ) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    out = {
        "tokens": torch.empty((b, s), dtype=torch.int32, device=META),
        "labels": torch.empty((b, s), dtype=torch.int32, device=META),
    }
    if cfg.family == "vlm":
        out["patches"] = torch.empty((b, cfg.n_patches, cfg.d_model),
                                     dtype=torch.bfloat16, device=META)
    if cfg.family == "encdec":
        out["frames"] = torch.empty((b, cfg.enc_frames, cfg.d_model),
                                    dtype=torch.bfloat16, device=META)
    return out


def param_specs(cfg: ModelConfig) -> nn.Module:
    """The model module with its parameters on ``meta``."""
    return api.init(cfg, None, META)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int
                ) -> Dict[str, torch.Tensor]:
    return api.init_cache(cfg, batch, max_len, device=META)


def opt_state_specs(cfg: ModelConfig, optimizer: opt.Optimizer,
                    params: Optional[nn.Module] = None) -> Params:
    """The optimizer's state over ``params`` (``param_specs(cfg)`` by
    default), on ``meta``."""
    params = param_specs(cfg) if params is None else params
    return optimizer.init(dict(params.named_parameters()))


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                optimizer: Optional[opt.Optimizer] = None
                ) -> Dict[str, Any]:
    """All inputs of the step this shape runs (train/prefill/decode); a
    train step's optimizer state is over its ``params``."""
    params = param_specs(cfg)
    if shape.kind == "train":
        optimizer = optimizer or opt.for_config(cfg)
        return {
            "params": params,
            "opt_state": opt_state_specs(cfg, optimizer, params),
            "batch": batch_specs(cfg, shape),
        }
    if shape.kind == "prefill":
        return {
            "params": params,
            "batch": batch_specs(cfg, shape),
        }
    # decode: one new token against a seq_len KV cache
    b = shape.global_batch
    return {
        "params": params,
        "cache": cache_specs(cfg, b, shape.seq_len),
        "token": torch.empty((b,), dtype=torch.int32, device=META),
        "pos": torch.empty((b,), dtype=torch.int32, device=META),
    }


# ---------------------------------------------------------------------- #
# step functions
# ---------------------------------------------------------------------- #
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


def _as_param(g, p: torch.Tensor):
    """A DTensor gradient ``g`` (a step walked over a mesh) laid out as
    its parameter ``p``: the partial sums of an FSDP-sharded weight's
    gradient reduce-scattered once, here, as jit's out-shardings ask,
    and not again at each use in the clip and the update.  Any other
    gradient as it is."""
    if is_sharded(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


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
        return loss.detach().float(), dict(zip(
            names, (_as_param(g, p) for g, p in zip(grads, leaves))))

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


def _no_grad(t: torch.Tensor):
    """``torch.inference_mode``, or ``torch.no_grad`` for a DTensor
    ``t`` (a step walked over a mesh, ``launch/dryrun.py``): DTensor's
    dispatch of ``Tensor.to`` fails under inference mode."""
    if is_sharded(t):
        return torch.no_grad()
    return torch.inference_mode()


def make_prefill_step(cfg: ModelConfig, device=None) -> Callable:
    """Forward logits over the full prompt (inference prefill)."""
    device = resolve_device(device)
    mod = api._mod(cfg)

    def prefill_step(params: nn.Module, batch: Dict[str, torch.Tensor]):
        with _no_grad(batch["tokens"]):
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
        with _no_grad(token):
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
