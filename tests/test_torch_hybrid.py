"""The port's hybrid family (jamba: Mamba2 + attention + MoE) against the
reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
model weights come from the reference's ``init`` and are carried into
the port with ``model_params_from_reference``.  On the CPU the port's
``ssd_chunk`` and ``flash_attention`` take their plain versions; the
reference's Mamba layers run its plain jnp SSD, as its model does.

Tolerances: float32 rtol = atol = 2e-5 for logits, the aux loss, the
loss and decode steps (reassociation only, as the dense and Mamba2
families).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import hybrid as JH

from repro_torch.carry import model_params_from_reference
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import api as tapi
from repro_torch.models import hybrid as TH
from repro_torch.models import moe as TM
from test_torch_transformer import (F32_TOL, _assert_same_tokens, _carried,
                                    _cfgs, _np, _serve_both)

ARCH = "jamba-1.5-large-398b"


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_exp():
    """The first large multithreaded ``torch.exp`` of a process can come
    back about 1e-4 off (MKL vector math on an AMX CPU; see
    test_torch_ssm.py): one throwaway call first."""
    torch.exp(torch.rand(1 << 22))


def test_superblock_layout():
    """One smoke superblock: attention at position 4, Mamba elsewhere,
    MoE at odd positions."""
    cfg = _cfgs(ARCH)[1]
    model = tapi.init(cfg, torch.Generator().manual_seed(0))
    assert TH.n_superblocks(cfg) == 1 == len(model.blocks)
    for i in range(cfg.hybrid_block):
        layer = model.blocks[0][f"layer{i}"]
        assert ("attn" in layer) == (i == 4) and ("mamba" in layer) != (i == 4)
        assert ("moe" in layer) == (i % 2 == 1) and ("ffn" in layer) != \
            (i % 2 == 1)


def test_forward_loss_and_serve_steps_match_reference():
    """2 x 64 tokens (4 chunks of 16): the MoE layers route 16 groups of
    8 tokens at capacity 5, so assignments drop."""
    cfg_j, cfg_t, params, model = _carried(ARCH)
    assert TM.dispatch_shape(cfg_t, 128) == (16, 5)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_j.vocab, size=(2, 64))
    labels = rng.integers(0, cfg_j.vocab, size=(2, 64))
    lj, aux_j = JH.forward(cfg_j, params, jnp.asarray(toks))
    with torch.inference_mode():
        lt, aux_t = TH.forward(cfg_t, model, torch.from_numpy(toks))
    assert tuple(lt.shape) == (2, 64, 512)
    np.testing.assert_allclose(_np(lt), _np(lj), **F32_TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **F32_TOL)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    with torch.inference_mode():
        loss_t = tapi.loss_fn(cfg_t, model, batch)
    loss_j = JH.loss_fn(cfg_j, params, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)})
    np.testing.assert_allclose(float(loss_t), float(loss_j), **F32_TOL)
    lp = make_prefill_step(cfg_t, device="cpu")(model, batch)
    np.testing.assert_allclose(_np(lp), _np(lj), **F32_TOL)

    cj = JH.init_cache(cfg_j, 2, 16, dtype=jnp.float32)
    ct = TH.init_cache(cfg_t, 2, 16, dtype=torch.float32)
    assert {k: tuple(v.shape) for k, v in ct.items()} == \
        {k: tuple(v.shape) for k, v in cj.items()}
    for t in range(4):
        tok, pos = toks[:, t], np.array([t, t + 2])
        aj, cj = JH.serve_step(cfg_j, params, cj, jnp.asarray(tok),
                               jnp.asarray(pos))
        with torch.inference_mode():
            at, ct = TH.serve_step(cfg_t, model, ct, torch.from_numpy(tok),
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(_np(at), _np(aj), **F32_TOL)
        for name in ("k", "v", "ssm", "conv"):
            np.testing.assert_allclose(_np(ct[name]), _np(cj[name]),
                                       **F32_TOL)


def test_carry_stacked_superblocks_equal_listed():
    """Two superblocks stacked by ``jax.vmap`` (scan_layers=True) and
    listed carry to the same module, ``blocks.{i}.layer{j}.*``."""
    cfg_j, cfg_t = _cfgs(ARCH, n_layers=16, scan_layers=True)
    stacked = jax.tree_util.tree_map(
        np.asarray, JH.init(cfg_j, jax.random.PRNGKey(0)))
    listed = dict(stacked, blocks=[
        jax.tree_util.tree_map(lambda v, i=i: v[i], stacked["blocks"])
        for i in range(2)])
    a = model_params_from_reference(stacked, cfg_t)
    b = model_params_from_reference(listed, cfg_t)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert {"blocks.1.layer4.attn.wq", "blocks.0.layer0.mamba.A_log",
            "blocks.1.layer7.moe.experts.w_gate",
            "blocks.0.layer2.ffn.w_in"} <= set(sa)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_carry_rejects_a_missing_parameter():
    cfg_j, cfg_t = _cfgs(ARCH)
    tree = jax.tree_util.tree_map(np.asarray,
                                  JH.init(cfg_j, jax.random.PRNGKey(0)))
    del tree["blocks"][0]["layer3"]["mamba"]["D"]
    with pytest.raises(KeyError, match="blocks.0.layer3.mamba.D"):
        model_params_from_reference(tree, cfg_t)


def test_server_matches_reference_server():
    js, ts, jreqs, treqs = _serve_both("float32", ARCH)
    _assert_same_tokens(js, jreqs, treqs, "float32", F32_TOL["atol"])
    assert list(ts.pos) == list(js.pos)
    assert set(ts.cache) == {"k", "v", "ssm", "conv"}
