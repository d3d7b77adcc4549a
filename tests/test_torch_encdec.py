"""The port's encoder-decoder family (whisper) against the reference, on
the CPU.

Inputs are made with numpy from a seed and handed to both packages;
model weights come from the reference's ``init`` and are carried into
the port with ``model_params_from_reference``.  On the CPU the port's
``flash_attention`` takes its plain version.

Tolerances:
  * float32: rtol = atol = 2e-5 for cross-attention, the encoder, the
    primed cross cache, logits, the loss and decode steps
    (reassociation only, as the dense family);
  * a bf16 cross cache in an fp32 model: atol 6e-2 (BF16_ATOL).  The
    reference promotes in the QK product and then rounds the softmax
    weights to bf16 for PV; the port casts the cache to fp32 for the
    kernel and keeps PV in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as JE
from repro.models import layers as JL

from repro_torch.carry import model_params_from_reference, tensor_from_array
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import api as tapi
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from test_torch_transformer import (BF16_ATOL, F32_TOL, _assert_same_tokens,
                                    _carried, _cfgs, _np, _serve_both, _x)

ARCH = "whisper-small"


def _frames(cfg, b=2, seed=5, dtype=np.float32):
    f = (np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_frames, cfg.d_model))).astype(dtype)
    return jnp.asarray(f), torch.from_numpy(f)


@pytest.mark.parametrize("sq", [1, 7])
def test_cross_attention_matches_reference(sq):
    """``attention(..., kv=...)``: non-causal over 16 encoder frames, q
    with RoPE at ``pos``, K/V as given (no RoPE)."""
    cfg_j, cfg_t, params, model = _carried(ARCH)
    xj, xt = _x(cfg_j, (2, sq, cfg_j.d_model))
    rng = np.random.default_rng(4)
    kv = [rng.standard_normal((2, cfg_j.enc_frames, cfg_j.n_kv_heads,
                               cfg_j.hdim)).astype(np.float32)
          for _ in range(2)]
    pos = np.array([3, 9])[:, None] + np.arange(sq)
    p = params["dec"][1]["cross"]
    want = JL.attention(cfg_j, p, xj, jnp.asarray(pos),
                        kv=tuple(jnp.asarray(a) for a in kv))
    with torch.inference_mode():
        got = TL.attention(cfg_t, model.dec[1].cross, xt,
                           torch.from_numpy(pos),
                           kv=tuple(torch.from_numpy(a) for a in kv))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    # a bf16 cross cache in the fp32 model: promoted, held at bf16
    kvb = [jnp.asarray(a, jnp.bfloat16) for a in kv]
    want = JL.attention(cfg_j, p, xj, jnp.asarray(pos), kv=tuple(kvb))
    with torch.inference_mode():
        got = TL.attention(cfg_t, model.dec[1].cross, xt,
                           torch.from_numpy(pos),
                           kv=tuple(tensor_from_array(np.asarray(a))
                                    for a in kvb))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=BF16_ATOL)


@pytest.mark.parametrize("frames_dtype", [np.float32, "bfloat16"])
def test_encode_and_prime_cache_match_reference(frames_dtype):
    """The encoder and the primed cross cache; bf16 frames in the fp32
    model keep a bf16 residual stream, as the reference promotes."""
    cfg_j, cfg_t, params, model = _carried(ARCH)
    fj, _ = _frames(cfg_j)
    if frames_dtype == "bfloat16":
        fj = fj.astype(jnp.bfloat16)
    ft = tensor_from_array(np.asarray(fj))
    want = JE.encode(cfg_j, params, fj)
    with torch.inference_mode():
        got = TE.encode(cfg_t, model, ft)
    assert got.dtype == ft.dtype
    tol = F32_TOL if frames_dtype == np.float32 else dict(atol=BF16_ATOL)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    cj = JE.prime_cache(cfg_j, params, JE.init_cache(cfg_j, 2, 8,
                                                     dtype=jnp.float32), fj)
    with torch.inference_mode():
        ct = TE.prime_cache(cfg_t, model, TE.init_cache(
            cfg_t, 2, 8, dtype=torch.float32), ft)
    assert set(ct) == {"k", "v", "xk", "xv"}
    assert tuple(ct["xk"].shape) == (cfg_t.n_layers, 2, cfg_t.enc_frames,
                                     cfg_t.n_kv_heads, cfg_t.hdim)
    for name in ("xk", "xv"):
        np.testing.assert_allclose(_np(ct[name]), _np(cj[name]), **tol)


def test_forward_loss_and_serve_steps_match_reference():
    cfg_j, cfg_t, params, model = _carried(ARCH)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_j.vocab, size=(2, 24))
    labels = rng.integers(0, cfg_j.vocab, size=(2, 24))
    fj, ft = _frames(cfg_j)
    lj = JE.forward(cfg_j, params, jnp.asarray(toks), fj)
    with torch.inference_mode():
        lt = TE.forward(cfg_t, model, torch.from_numpy(toks), ft)
    assert tuple(lt.shape) == (2, 24, 512)
    np.testing.assert_allclose(_np(lt), _np(lj), **F32_TOL)
    batch_j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
               "frames": fj}
    batch_t = {"tokens": torch.from_numpy(toks),
               "labels": torch.from_numpy(labels), "frames": ft}
    with torch.inference_mode():
        loss_t = tapi.loss_fn(cfg_t, model, batch_t)
    np.testing.assert_allclose(float(loss_t),
                               float(JE.loss_fn(cfg_j, params, batch_j)),
                               **F32_TOL)
    lp = make_prefill_step(cfg_t, device="cpu")(model, batch_t)
    np.testing.assert_allclose(_np(lp), _np(lj), **F32_TOL)

    cj = JE.prime_cache(cfg_j, params,
                        JE.init_cache(cfg_j, 2, 16, dtype=jnp.float32), fj)
    with torch.inference_mode():
        ct = TE.prime_cache(cfg_t, model,
                            TE.init_cache(cfg_t, 2, 16, dtype=torch.float32),
                            ft)
    for t in range(4):
        tok, pos = toks[:, t], np.array([t, t + 2])
        aj, cj = JE.serve_step(cfg_j, params, cj, jnp.asarray(tok),
                               jnp.asarray(pos))
        with torch.inference_mode():
            at, ct = TE.serve_step(cfg_t, model, ct, torch.from_numpy(tok),
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(_np(at), _np(aj), **F32_TOL)
        for name in ("k", "v", "xk", "xv"):
            np.testing.assert_allclose(_np(ct[name]), _np(cj[name]),
                                       **F32_TOL)


def test_decode_with_a_bf16_cache_in_an_fp32_model():
    """``api.init_cache``'s default bf16 cache, primed from bf16 frames:
    the self cache is widened to fp32 as the reference's blend promotes
    it; the cross cache stays bf16 and is held at the bf16 tolerance."""
    cfg_j, cfg_t, params, model = _carried(ARCH)
    fj, _ = _frames(cfg_j)
    fj = fj.astype(jnp.bfloat16)
    ft = tensor_from_array(np.asarray(fj))
    cj = JE.prime_cache(cfg_j, params, JE.init_cache(cfg_j, 2, 8), fj)
    with torch.inference_mode():
        ct = TE.prime_cache(cfg_t, model, tapi.init_cache(cfg_t, 2, 8), ft)
    assert ct["xk"].dtype == torch.bfloat16
    for t in range(3):
        tok, pos = np.array([5 + t, 9]), np.array([t, t])
        aj, cj = JE.serve_step(cfg_j, params, cj, jnp.asarray(tok),
                               jnp.asarray(pos))
        with torch.inference_mode():
            at, ct = TE.serve_step(cfg_t, model, ct, torch.from_numpy(tok),
                                   torch.from_numpy(pos))
        assert ct["k"].dtype == torch.float32
        np.testing.assert_allclose(_np(at), _np(aj), atol=BF16_ATOL)


def test_carry_stacked_layers_equal_listed():
    """``enc`` and ``dec`` stacked by ``jax.vmap`` (scan_layers=True) and
    listed carry to the same module; ``ln_enc`` rides at the top."""
    cfg_j, cfg_t = _cfgs(ARCH, scan_layers=True)
    stacked = jax.tree_util.tree_map(
        np.asarray, JE.init(cfg_j, jax.random.PRNGKey(0)))
    assert isinstance(stacked["enc"], dict) and isinstance(stacked["dec"],
                                                           dict)
    listed = dict(stacked, **{
        key: [jax.tree_util.tree_map(lambda v, i=i: v[i], stacked[key])
              for i in range(n)]
        for key, n in (("enc", cfg_j.enc_layers), ("dec", cfg_j.n_layers))})
    a = model_params_from_reference(stacked, cfg_t)
    b = model_params_from_reference(listed, cfg_t)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert {"ln_enc.scale", "enc.1.ffn.w_out", "dec.3.self.wq",
            "dec.0.cross.wv"} <= set(sa)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_carry_rejects_a_missing_parameter():
    cfg_j, cfg_t = _cfgs(ARCH)
    tree = jax.tree_util.tree_map(np.asarray,
                                  JE.init(cfg_j, jax.random.PRNGKey(0)))
    del tree["dec"][1]["cross"]["wk"]
    with pytest.raises(KeyError, match="dec.1.cross.wk"):
        model_params_from_reference(tree, cfg_t)
    tree = jax.tree_util.tree_map(np.asarray,
                                  JE.init(cfg_j, jax.random.PRNGKey(0)))
    del tree["ln_enc"]
    with pytest.raises(KeyError, match="ln_enc.scale"):
        model_params_from_reference(tree, cfg_t)


def test_server_matches_reference_server():
    """The reference's server never primes the cross cache, and neither
    does the port's (the cross-attention reads zeros): in float32 the
    two give the same greedy tokens but for near-ties."""
    js, ts, jreqs, treqs = _serve_both("float32", ARCH)
    _assert_same_tokens(js, jreqs, treqs, "float32", F32_TOL["atol"])
    assert list(ts.pos) == list(js.pos)
    assert float(ts.cache["xk"].abs().max()) == 0.0


def test_make_batch_has_bf16_frames():
    cfg = _cfgs(ARCH)[1]
    made = tapi.make_batch(cfg, torch.Generator().manual_seed(0), 2, 8)
    assert made["frames"].shape == (2, cfg.enc_frames, cfg.d_model)
    assert made["frames"].dtype == torch.bfloat16
    assert made["tokens"].shape == made["labels"].shape == (2, 8)
