"""The port's MoE family (grok-1, qwen2-moe) against the reference, on the
CPU.

Inputs are made with numpy from a seed and handed to both packages;
model weights come from the reference's ``init`` and are carried into
the port with ``model_params_from_reference``.  On the CPU the port's
``flash_attention`` takes its plain version.

Tolerances:
  * routing: ``eid``, ``slot`` and ``keep`` equal, ``gate`` to 2e-5 (the
    same fp32 softmax, summed in another order);
  * float32: rtol = atol = 2e-5 for ``moe_ffn``, ``aux``, logits, the
    loss and decode steps (reassociation only, as the dense family);
  * bfloat16: atol 6e-2 on outputs of magnitude about 1 (eight bf16 ulps
    at 1.0), as the dense family.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM

from repro_torch.carry import model_params_from_reference, tensor_from_array
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from test_torch_transformer import (BF16_ATOL, F32_TOL, _assert_same_tokens,
                                    _carried, _cfgs, _np, _serve_both, _x)

#: routed experts without and with shared experts
ARCHS = ["grok-1-314b", "qwen2-moe-a2.7b"]


def _ref_route(logits: np.ndarray, k: int, capacity: int):
    """The reference's routing of [g, t, e] logits, group by group, as
    its ``moe_ffn`` vmaps it."""
    return jax.vmap(lambda lx: JM.route(lx, k, capacity))(
        jnp.asarray(logits))


def _assert_same_routes(got, want):
    for name, g, w in zip(("eid", "slot", "keep"), got[:3], want[:3]):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    np.testing.assert_allclose(_np(got[3]), _np(want[3]), **F32_TOL)


def test_route_with_drops_in_16_groups():
    """t = 16 groups of 32 tokens, top-2 of 8 experts at capacity 10
    (a mean load of 8): some assignments drop, and the slots, the kept
    set and the gates equal the reference's."""
    cfg_j, cfg_t = _cfgs("grok-1-314b", moe=dataclasses.replace(
        _cfgs("grok-1-314b")[1].moe, n_experts=8))
    t = 512
    g, capacity = TM.dispatch_shape(cfg_t, t)
    assert (g, capacity) == (16, max(1, int(1.25 * 32 * 2 // 8)))
    logits = np.random.default_rng(0).standard_normal((g, t // g, 8)) \
        .astype(np.float32)
    got = TM.route(torch.from_numpy(logits), 2, capacity)
    want = _ref_route(logits, 2, capacity)
    _assert_same_routes(got, want)
    dropped = 1 - float(got[2].float().mean())
    assert 0.01 < dropped < 0.5
    assert int(got[1].max()) > capacity


def test_route_orders_ties_as_lax_top_k():
    """Equal probabilities keep the lower expert first, as
    ``jax.lax.top_k`` orders them; ``torch.topk`` need not."""
    logits = np.zeros((1, 6, 4), np.float32)
    logits[0, 3] = [0.0, 1.0, 1.0, 0.0]             # a tie between 1 and 2
    got = TM.route(torch.from_numpy(logits), 2, 2)
    _assert_same_routes(got, _ref_route(logits, 2, 2))
    eid = got[0].reshape(6, 2)
    assert eid[0].tolist() == [0, 1] and eid[3].tolist() == [1, 2]
    # the third token's [0, 1] arrive as each expert's slot 2: dropped
    assert got[1].reshape(6, 2)[2].tolist() == [2, 2]
    assert not bool(got[2].reshape(6, 2)[2].any())


@pytest.mark.parametrize("t,want", [(4 * 2048, (16, 42)), (4, (1, 1)),
                                    (256, (16, 1)), (16, (1, 1))])
def test_dispatch_shape_at_qwen2_moe_sizes(t, want):
    """Qwen2-MoE (60 experts, top-4, capacity factor 1.25): a 4 x 2048
    prefill, batch-4 decode, a 256-token prefill, and 16 tokens (fewer
    than 16 k: one group)."""
    import repro_torch.configs as C
    assert TM.dispatch_shape(C.get("qwen2-moe-a2.7b"), t) == want
    big = dataclasses.replace(C.get("qwen2-moe-a2.7b"), moe=dataclasses.replace(
        C.get("qwen2-moe-a2.7b").moe, capacity_factor=60.0))
    assert TM.dispatch_shape(big, 256) == (16, 64)
    assert TM.dispatch_shape(big, 1) == (1, 4)
    assert TM.dispatch_shape(C.get("jamba-1.5-large-398b"), 8192) == (16, 128)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_and_aux_match_reference(arch, dtype):
    """2 x 64 tokens: 16 groups of 8 at capacity 5, so assignments drop;
    the output and the aux loss equal the reference's."""
    cfg_j, cfg_t, params, model = _carried(arch, dtype)
    xj, xt = _x(cfg_j, (2, 64, cfg_j.d_model), seed=3)
    pj = params["blocks"][1]["moe"]
    want, aux_j = JM.moe_ffn(cfg_j, pj, xj)
    with torch.inference_mode():
        got, aux_t = TM.moe_ffn(cfg_t, model.blocks[1].moe, xt)
    assert ("shared" in model.blocks[1].moe) == (arch == "qwen2-moe-a2.7b")
    assert got.dtype == xt.dtype and aux_t.dtype == torch.float32
    tol = F32_TOL if dtype == "float32" else dict(atol=BF16_ATOL)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **F32_TOL)
    g, capacity = TM.dispatch_shape(cfg_t, 128)
    logits = (xt.reshape(128, -1).float() @ model.blocks[1].moe.router)
    keep = TM.route(logits.reshape(g, -1, cfg_t.moe.n_experts),
                    cfg_t.moe.top_k, capacity)[2]
    assert g == 16 and not bool(keep.all())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_serve_steps_match_reference(arch):
    cfg_j, cfg_t, params, model = _carried(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_j.vocab, size=(2, 32))
    labels = rng.integers(0, cfg_j.vocab, size=(2, 32))
    lj, aux_j = JM.forward(cfg_j, params, jnp.asarray(toks))
    with torch.inference_mode():
        lt, aux_t = TM.forward(cfg_t, model, torch.from_numpy(toks))
    assert tuple(lt.shape) == (2, 32, 512)
    np.testing.assert_allclose(_np(lt), _np(lj), **F32_TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **F32_TOL)
    loss_j = JM.loss_fn(cfg_j, params, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)})
    with torch.inference_mode():
        loss_t = tapi.loss_fn(cfg_t, model, {
            "tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(loss_t), float(loss_j), **F32_TOL)

    cj = JM.init_cache(cfg_j, 2, 16, dtype=jnp.float32)
    ct = TM.init_cache(cfg_t, 2, 16, dtype=torch.float32)
    for t in range(4):
        tok, pos = toks[:, t], np.array([t, t + 2])
        aj, cj = JM.serve_step(cfg_j, params, cj, jnp.asarray(tok),
                               jnp.asarray(pos))
        with torch.inference_mode():
            at, ct = TM.serve_step(cfg_t, model, ct, torch.from_numpy(tok),
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(_np(at), _np(aj), **F32_TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(ct[name]), _np(cj[name]),
                                       **F32_TOL)


def test_prefill_step_returns_logits_only():
    cfg_j, cfg_t, params, model = _carried("qwen2-moe-a2.7b")
    toks = np.random.default_rng(1).integers(0, cfg_j.vocab, size=(2, 16))
    lt = make_prefill_step(cfg_t, device="cpu")(
        model, {"tokens": torch.from_numpy(toks)})
    lj, _ = JM.forward(cfg_j, params, jnp.asarray(toks))
    assert isinstance(lt, torch.Tensor)
    np.testing.assert_allclose(_np(lt), _np(lj), **F32_TOL)
    # decode through the step, into a bf16 cache the fp32 model widens
    step = make_serve_step(cfg_t, device="cpu")
    cache = tapi.init_cache(cfg_t, 2, 8)
    logits, cache = step(model, cache, torch.from_numpy(toks[:, 0]),
                         torch.zeros(2, dtype=torch.long))
    assert cache["k"].dtype == torch.float32 and logits.shape == (2, 512)


def test_carry_stacked_blocks_equal_listed():
    """scan_layers=True (the full configs' vmap-stacked blocks, experts
    stacked inside) and a list of blocks carry to the same module."""
    cfg_j, cfg_t = _cfgs("qwen2-moe-a2.7b", scan_layers=True)
    stacked = jax.tree_util.tree_map(
        np.asarray, JM.init(cfg_j, jax.random.PRNGKey(0)))
    assert stacked["blocks"]["moe"]["experts"]["w_in"].shape == \
        (cfg_j.n_layers, 4, cfg_j.d_model, 64)
    listed = dict(stacked, blocks=[
        jax.tree_util.tree_map(lambda v, i=i: v[i], stacked["blocks"])
        for i in range(cfg_j.n_layers)])
    a = model_params_from_reference(stacked, cfg_t)
    b = model_params_from_reference(listed, cfg_t)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert "blocks.3.moe.shared.w_gate" in sa and "blocks.0.moe.router" in sa
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.blocks[0].moe.router.dtype == torch.float32


def test_carry_rejects_a_missing_parameter():
    cfg_j, cfg_t = _cfgs("qwen2-moe-a2.7b")
    tree = jax.tree_util.tree_map(np.asarray,
                                  JM.init(cfg_j, jax.random.PRNGKey(0)))
    del tree["blocks"][2]["moe"]["shared"]["w_out"]
    with pytest.raises(KeyError, match="blocks.2.moe.shared.w_out"):
        model_params_from_reference(tree, cfg_t)
    tree = jax.tree_util.tree_map(np.asarray,
                                  JM.init(cfg_j, jax.random.PRNGKey(0)))
    tree["blocks"] = tree["blocks"][:3]
    with pytest.raises(ValueError, match="3 blocks for 4 layers"):
        model_params_from_reference(tree, cfg_t)


def test_server_matches_reference_server():
    """The slots of a decode step are routed together (one group at
    capacity 1 here, so slots compete for experts): in float32 the two
    servers give the same greedy tokens but for near-ties."""
    js, ts, jreqs, treqs = _serve_both("float32", "qwen2-moe-a2.7b")
    _assert_same_tokens(js, jreqs, treqs, "float32", F32_TOL["atol"])
    assert list(ts.pos) == list(js.pos)


def test_init_ffn_width_override():
    cfg = _cfgs("qwen2-7b")[1]
    p = TL.init_ffn(cfg, torch.Generator().manual_seed(0), d_ff=48)
    assert tuple(p.w_in.shape) == (cfg.d_model, 48)
    assert tuple(p.w_out.shape) == (48, cfg.d_model)
    assert tuple(TL.init_ffn(cfg, None).w_in.shape) == (cfg.d_model,
                                                         cfg.d_ff)
    x = tensor_from_array(np.ones((1, 2, cfg.d_model), np.float32))
    assert tuple(TL.ffn(cfg, p, x).shape) == (1, 2, cfg.d_model)
