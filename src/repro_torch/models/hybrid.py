"""Jamba-style hybrid Mamba+attention+MoE model  [arXiv:2403.19887]: the
PyTorch port of the reference's ``models/hybrid.py``, forward only.

The layer stack is organized into *superblocks* of ``cfg.hybrid_block``
layers (Jamba: 8).  Within a superblock, position ``hybrid_attn_idx``
(Jamba: 4) is an attention layer and all others are Mamba layers; the
FFN at odd positions is MoE and at even positions dense
(``moe_every=2``).  The Mamba layers run ``ssd_chunk`` and the attention
layer ``flash_attention`` in prefill.

Parameters sit in ``Params`` modules (``Superblock``, ``HybridLM``)
under the reference's names: ``blocks.{i}.layer{j}`` holds ``ln1``,
``ln2``, ``attn`` or ``mamba``, and ``moe`` or ``ffn``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.layers import Params


def n_superblocks(cfg: ModelConfig) -> int:
    assert cfg.n_layers % cfg.hybrid_block == 0
    return cfg.n_layers // cfg.hybrid_block


def _is_attn(cfg: ModelConfig, pos: int) -> bool:
    return pos == cfg.hybrid_attn_idx


def _is_moe(cfg: ModelConfig, pos: int) -> bool:
    return cfg.moe is not None and pos % cfg.moe_every == cfg.moe_every - 1


# ---------------------------------------------------------------------- #
# parameters
# ---------------------------------------------------------------------- #
class Superblock(Params):
    """``layer0`` .. ``layer{hybrid_block - 1}``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        for i in range(cfg.hybrid_block):
            layer = Params()
            layer.ln1 = L.init_rmsnorm(cfg, device=device)
            layer.ln2 = L.init_rmsnorm(cfg, device=device)
            if _is_attn(cfg, i):
                layer.attn = L.init_attention(cfg, gen, device)
            else:
                layer.mamba = SSM.MambaLayer(cfg, gen, device)
            if _is_moe(cfg, i):
                layer.moe = MOE.init_moe_layer(cfg, gen, device)
            else:
                layer.ffn = L.init_ffn(cfg, gen, device)
            self.add_module(f"layer{i}", layer)


class HybridLM(Params):
    """The language model: ``embed``, ``blocks`` (one superblock each)
    and ``ln_f``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.embed = L.init_embedding(cfg, gen, device)
        self.blocks = nn.ModuleList(Superblock(cfg, gen, device)
                                    for _ in range(n_superblocks(cfg)))
        self.ln_f = L.init_rmsnorm(cfg, device=device)


def init(cfg: ModelConfig, gen: Optional[torch.Generator],
         device=None) -> HybridLM:
    """Seeded weights from ``gen`` on ``device`` (the generator's device
    by default); without a generator, uninitialised weights for
    ``carry`` to load."""
    if device is None and gen is not None:
        device = gen.device
    return HybridLM(cfg, gen, device)


# ---------------------------------------------------------------------- #
# forward
# ---------------------------------------------------------------------- #
def _ffn(cfg: ModelConfig, layer, i: int, h: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Position ``i``'s FFN: (output, aux loss or None for a dense FFN)."""
    if _is_moe(cfg, i):
        return MOE.moe_ffn(cfg, layer["moe"], h)
    return L.ffn(cfg, layer["ffn"], h), None


def superblock_fwd(cfg: ModelConfig, sb, x: torch.Tensor, pos: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.hybrid_block):
        layer = sb[f"layer{i}"]
        h = L.norm(cfg, layer["ln1"], x)
        if _is_attn(cfg, i):
            x = x + L.attention(cfg, layer["attn"], h, pos)
        else:
            x = x + SSM.mamba_layer(cfg, layer["mamba"], h)
        y, aux = _ffn(cfg, layer, i, L.norm(cfg, layer["ln2"], x))
        if aux is not None:
            aux_total = aux_total + aux
        x = x + y
    return x, aux_total


def forward(cfg: ModelConfig, params, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [b, s] (s a multiple of the SSM chunk) -> (logits [b, s,
    padded vocab], summed aux loss)."""
    x = L.embed(cfg, params["embed"], tokens)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for sb in params["blocks"]:
        x, aux = superblock_fwd(cfg, sb, x, pos)
        aux_total = aux_total + aux
    x = L.norm(cfg, params["ln_f"], x)
    return L.lm_head(cfg, params["embed"], x), aux_total


def loss_fn(cfg: ModelConfig, params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Forward only: the port has no backward yet (ROADMAP.md)."""
    logits, aux = forward(cfg, params, batch["tokens"])
    loss = L.softmax_xent(logits, batch["labels"])
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux / cfg.n_layers
    return loss


# ---------------------------------------------------------------------- #
# decode
# ---------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    ns = n_superblocks(cfg)
    n_mamba = cfg.hybrid_block - 1
    d_in, nh, p, n, conv_dim = SSM.dims(cfg)
    kv = (ns, batch, max_len, cfg.n_kv_heads, cfg.hdim)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "ssm": torch.zeros((ns, n_mamba, batch, nh, p, n),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((ns, n_mamba, batch, cfg.ssm.d_conv - 1,
                             conv_dim), dtype=dtype, device=device),
    }


def superblock_decode(cfg: ModelConfig, sb, x: torch.Tensor, ck, cv, ssm_s,
                      conv_s, pos: torch.Tensor):
    """One token through a superblock: the attention layer writes its key
    and value into ``ck``, ``cv`` in place; the Mamba layers return new
    states, stacked."""
    mi = 0
    new_ssm, new_conv = [], []
    for i in range(cfg.hybrid_block):
        layer = sb[f"layer{i}"]
        h = L.norm(cfg, layer["ln1"], x)
        if _is_attn(cfg, i):
            a, ck, cv = L.attention_decode(cfg, layer["attn"], h, ck, cv,
                                           pos)
            x = x + a
        else:
            y, ss, cs = SSM.mamba_decode(cfg, layer["mamba"], h,
                                         ssm_s[mi], conv_s[mi])
            new_ssm.append(ss)
            new_conv.append(cs)
            mi += 1
            x = x + y
        y, _ = _ffn(cfg, layer, i, L.norm(cfg, layer["ln2"], x))
        x = x + y
    return x, ck, cv, torch.stack(new_ssm), torch.stack(new_conv)


def serve_step(cfg: ModelConfig, params, cache: Dict[str, torch.Tensor],
               token: torch.Tensor, pos: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: token [b], pos [b] -> logits [b, padded vocab]."""
    x = L.embed(cfg, params["embed"], token[:, None])
    ks, vs = T.widen_kv(cache, x.dtype)
    sss, css = [], []
    for i, sb in enumerate(params["blocks"]):
        x, _, _, ss, cs = superblock_decode(
            cfg, sb, x, ks[i], vs[i], cache["ssm"][i], cache["conv"][i], pos)
        sss.append(ss)
        css.append(cs)
    x = L.norm(cfg, params["ln_f"], x)
    return L.lm_head(cfg, params["embed"], x)[:, 0], \
        {"k": ks, "v": vs, "ssm": torch.stack(sss), "conv": torch.stack(css)}
