"""Decoder-only GQA transformer (granite, qwen3, qwen2, olmo, llava): the
PyTorch port of the reference's ``models/transformer.py``.

Parameters sit in ``Params`` modules (``TransformerBlock``,
``TransformerLM``) under the reference's names; the reference's scanned
layer stack is a list here, run by a Python loop, each block under
``L.remat`` (rematerialised in the backward when ``cfg.remat``).  Attention runs on the
``flash_attention`` kernel in prefill (``layers.mha``) and in plain torch
in decode (``layers.attention_decode``), as in the reference.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import Params


# ---------------------------------------------------------------------- #
# parameters
# ---------------------------------------------------------------------- #
class TransformerBlock(Params):
    """Pre-norm residual block: ``ln1``, ``attn``, ``ln2``, ``ffn``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.ln1 = L.init_rmsnorm(cfg, device=device)
        self.attn = L.init_attention(cfg, gen, device)
        self.ln2 = L.init_rmsnorm(cfg, device=device)
        self.ffn = L.init_ffn(cfg, gen, device)


class TransformerLM(Params):
    """The language model: ``embed``, ``blocks`` (one per layer) and
    ``ln_f``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.embed = L.init_embedding(cfg, gen, device)
        self.blocks = nn.ModuleList(TransformerBlock(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.init_rmsnorm(cfg, device=device)


def init(cfg: ModelConfig, gen: Optional[torch.Generator],
         device=None) -> TransformerLM:
    """Seeded weights from ``gen`` on ``device`` (the generator's device
    by default; torch requires the two to match).  Without a generator,
    uninitialised weights for ``carry`` to load."""
    if device is None and gen is not None:
        device = gen.device
    return TransformerLM(cfg, gen, device)


# ---------------------------------------------------------------------- #
# forward (prefill)
# ---------------------------------------------------------------------- #
def block_fwd(cfg: ModelConfig, p, x: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    x = x + L.attention(cfg, p["attn"], L.norm(cfg, p["ln1"], x), pos)
    x = x + L.ffn(cfg, p["ffn"], L.norm(cfg, p["ln2"], x))
    return x


def forward(cfg: ModelConfig, params, tokens: torch.Tensor,
            extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [b, s] -> logits [b, s(+p), padded vocab].  ``extra_embeds``
    (vlm patch stubs) are prepended to the token embeddings."""
    x = L.embed(cfg, params["embed"], tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    bf = L.remat(cfg, lambda blk, h: block_fwd(cfg, blk, h, pos))
    for blk in params["blocks"]:
        x = bf(blk, x)
    x = L.norm(cfg, params["ln_f"], x)
    return L.lm_head(cfg, params["embed"], x)


def loss_fn(cfg: ModelConfig, params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token-mean cross entropy of the next-token logits; under
    autograd its gradient runs the ``flash_attention`` backward kernel
    on the card."""
    logits = forward(cfg, params, batch["tokens"],
                     extra_embeds=batch.get("patches"))
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:     # vlm: drop patch positions
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    return L.softmax_xent(logits, labels)


# ---------------------------------------------------------------------- #
# decode (serve_step)
# ---------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hdim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def widen_kv(cache: Dict[str, torch.Tensor], dtype: torch.dtype
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache's ``k`` and ``v``, widened to their promoted dtype with
    ``dtype`` when narrower (a copy), else the cache's own tensors."""
    ks, vs = cache["k"], cache["v"]
    wide = torch.promote_types(ks.dtype, dtype)
    if ks.dtype != wide:
        ks, vs = ks.to(wide), vs.to(wide)
    return ks, vs


def decode_block(cfg: ModelConfig, p, x: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor, pos: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    a, ck, cv = L.attention_decode(cfg, p["attn"], L.norm(cfg, p["ln1"], x),
                                   ck, cv, pos)
    x = x + a
    x = x + L.ffn(cfg, p["ffn"], L.norm(cfg, p["ln2"], x))
    return x, ck, cv


def serve_step(cfg: ModelConfig, params, cache: Dict[str, torch.Tensor],
               token: torch.Tensor, pos: torch.Tensor,
               block: Callable = decode_block
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: token [b], pos [b] -> logits [b, padded vocab].

    Each layer writes its new key and value into the stacked cache in
    place (the reference returns a new cache); a cache narrower than the
    model's dtype is widened once first, as the reference promotes it.
    ``block`` is the layer's decode (the MoE family passes its own)."""
    x = L.embed(cfg, params["embed"], token[:, None])
    ks, vs = widen_kv(cache, x.dtype)
    for i, blk in enumerate(params["blocks"]):
        x, _, _ = block(cfg, blk, x, ks[i], vs[i], pos)
    x = L.norm(cfg, params["ln_f"], x)
    logits = L.lm_head(cfg, params["embed"], x)
    return logits[:, 0], {"k": ks, "v": vs}
