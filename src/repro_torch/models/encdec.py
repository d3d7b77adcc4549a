"""Whisper-style encoder-decoder backbone  [arXiv:2212.04356]: the PyTorch
port of the reference's ``models/encdec.py``.

The conv audio frontend is a stub, as in the reference: the encoder
consumes precomputed frame embeddings ([b, enc_frames, d_model]).  The
encoder is bidirectional; the decoder has causal self-attention plus
cross-attention into the encoder output.  Positions use RoPE in place of
Whisper's learned absolute embeddings, as in the reference.

Parameters sit in ``Params`` modules (``EncBlock``, ``DecBlock``,
``EncDecLM``) under the reference's names.  Every attention of the
prefill (encoder, decoder self- and cross-attention) and the decode
step's cross-attention (one query over the cached encoder keys) run on
the ``flash_attention`` kernel; decode self-attention is plain torch,
as in the dense family.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import Params


# ---------------------------------------------------------------------- #
# parameters
# ---------------------------------------------------------------------- #
class EncBlock(Params):
    """Encoder block: ``ln1``, ``attn``, ``ln2``, ``ffn``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.ln1 = L.init_rmsnorm(cfg, device=device)
        self.attn = L.init_attention(cfg, gen, device)
        self.ln2 = L.init_rmsnorm(cfg, device=device)
        self.ffn = L.init_ffn(cfg, gen, device)


class DecBlock(Params):
    """Decoder block: ``ln1``, ``self`` (attention), ``lnx``, ``cross``
    (attention into the encoder output), ``ln2``, ``ffn``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.ln1 = L.init_rmsnorm(cfg, device=device)
        self.add_module("self", L.init_attention(cfg, gen, device))
        self.lnx = L.init_rmsnorm(cfg, device=device)
        self.cross = L.init_attention(cfg, gen, device)
        self.ln2 = L.init_rmsnorm(cfg, device=device)
        self.ffn = L.init_ffn(cfg, gen, device)


class EncDecLM(Params):
    """The model: ``embed``, ``enc`` and ``dec`` (one block per layer),
    ``ln_enc`` and ``ln_f``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.embed = L.init_embedding(cfg, gen, device)
        self.enc = nn.ModuleList(EncBlock(cfg, gen, device)
                                 for _ in range(cfg.enc_layers))
        self.dec = nn.ModuleList(DecBlock(cfg, gen, device)
                                 for _ in range(cfg.n_layers))
        self.ln_enc = L.init_rmsnorm(cfg, device=device)
        self.ln_f = L.init_rmsnorm(cfg, device=device)


def init(cfg: ModelConfig, gen: Optional[torch.Generator],
         device=None) -> EncDecLM:
    """Seeded weights from ``gen`` on ``device`` (the generator's device
    by default); without a generator, uninitialised weights for
    ``carry`` to load."""
    if device is None and gen is not None:
        device = gen.device
    return EncDecLM(cfg, gen, device)


# ---------------------------------------------------------------------- #
# encoder
# ---------------------------------------------------------------------- #
def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: [b, enc_frames, d_model] (precomputed conv-stub output).
    The residual stream keeps the frames' dtype, as in the reference:
    bf16 frames in an fp32 model meet the weights in fp32 and each
    block's output is rounded back to bf16."""
    x = frames
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None].expand(b, s)

    def blk_fwd(p, x):
        x = x + L.attention(cfg, p["attn"], L.norm(cfg, p["ln1"], x), pos,
                            causal=False)
        return x + L.ffn(cfg, p["ffn"], L.norm(cfg, p["ln2"], x))
    bf = L.remat(cfg, blk_fwd)
    for p in params["enc"]:
        x = bf(p, x)
    return L.norm(cfg, params["ln_enc"], x)


# ---------------------------------------------------------------------- #
# decoder (teacher-forced)
# ---------------------------------------------------------------------- #
def _cross_kv(cfg: ModelConfig, p, enc_out: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, _ = enc_out.shape
    nkv, h = cfg.n_kv_heads, cfg.hdim
    k = L.split_heads(L._mm(enc_out, p["wk"]), nkv, h, "kv_heads")
    v = L.split_heads(L._mm(enc_out, p["wv"]), nkv, h, "kv_heads")
    if cfg.qkv_bias:
        k = k + p["bk"].reshape(nkv, h)
        v = v + p["bv"].reshape(nkv, h)
    # as ``layers._qkv`` constrains the self-attention's keys and values
    return (L.constrain(k, ("batch", "seq", "kv_heads", None)),
            L.constrain(v, ("batch", "seq", "kv_heads", None)))


def dec_block_fwd(cfg: ModelConfig, p, x: torch.Tensor, pos: torch.Tensor,
                  enc_out: torch.Tensor) -> torch.Tensor:
    x = x + L.attention(cfg, p["self"], L.norm(cfg, p["ln1"], x), pos)
    kv = _cross_kv(cfg, p["cross"], enc_out)
    x = x + L.attention(cfg, p["cross"], L.norm(cfg, p["lnx"], x), pos,
                        kv=kv)
    return x + L.ffn(cfg, p["ffn"], L.norm(cfg, p["ln2"], x))


def forward(cfg: ModelConfig, params, tokens: torch.Tensor,
            frames: torch.Tensor) -> torch.Tensor:
    """tokens [b, s], frames [b, enc_frames, d_model] -> logits [b, s,
    padded vocab]."""
    enc_out = encode(cfg, params, frames)
    x = L.embed(cfg, params["embed"], tokens)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    df = L.remat(cfg, lambda blk, h: dec_block_fwd(cfg, blk, h, pos,
                                                   enc_out))
    for blk in params["dec"]:
        x = df(blk, x)
    x = L.norm(cfg, params["ln_f"], x)
    return L.lm_head(cfg, params["embed"], x)


def loss_fn(cfg: ModelConfig, params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token-mean cross entropy of the decoder's logits."""
    logits = forward(cfg, params, batch["tokens"], batch["frames"])
    return L.softmax_xent(logits, batch["labels"])


# ---------------------------------------------------------------------- #
# decode: self-attn KV cache + precomputed cross-attn KV
# ---------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    n, nkv, h = cfg.n_layers, cfg.n_kv_heads, cfg.hdim

    def zeros(s):
        return torch.zeros((n, batch, s, nkv, h), dtype=dtype, device=device)

    # cross-attention K/V: computed once from the encoder output
    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(cfg.enc_frames), "xv": zeros(cfg.enc_frames)}


def prime_cache(cfg: ModelConfig, params, cache: Dict[str, torch.Tensor],
                frames: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Run the encoder and fill the cross-attention K/V (a new cache;
    ``k`` and ``v`` are the given cache's)."""
    enc_out = encode(cfg, params, frames)
    kvs = [_cross_kv(cfg, blk["cross"], enc_out) for blk in params["dec"]]
    xk = torch.stack([k for k, _ in kvs])
    xv = torch.stack([v for _, v in kvs])
    return {**cache, "xk": xk.to(cache["xk"].dtype),
            "xv": xv.to(cache["xv"].dtype)}


def _dec_block_step(cfg, p, x, ck, cv, xk, xv, pos):
    a, ck, cv = L.attention_decode(cfg, p["self"], L.norm(cfg, p["ln1"], x),
                                   ck, cv, pos)
    x = x + a
    x = x + L.attention(cfg, p["cross"], L.norm(cfg, p["lnx"], x),
                        pos[:, None], kv=(xk, xv))
    return x + L.ffn(cfg, p["ffn"], L.norm(cfg, p["ln2"], x)), ck, cv


def serve_step(cfg: ModelConfig, params, cache: Dict[str, torch.Tensor],
               token: torch.Tensor, pos: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: token [b], pos [b] -> logits [b, padded vocab].
    The self-attention cache is written in place (widened first when
    narrower than the model, as in the dense family); the cross cache is
    read only."""
    x = L.embed(cfg, params["embed"], token[:, None])
    ks, vs = T.widen_kv(cache, x.dtype)
    for i, blk in enumerate(params["dec"]):
        x, _, _ = _dec_block_step(cfg, blk, x, ks[i], vs[i], cache["xk"][i],
                                  cache["xv"][i], pos)
    x = L.norm(cfg, params["ln_f"], x)
    return L.lm_head(cfg, params["embed"], x)[:, 0], \
        {**cache, "k": ks, "v": vs}
