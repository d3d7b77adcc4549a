"""The port's dense transformer path against the reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
model weights come from the reference's ``init`` and are carried into
the port with ``model_params_from_reference``.  The reference initialises
the QKV biases to zero and the norm scales to one, so before carrying
they get random values in the reference tree: the bias and qk-norm paths
are really compared.  On the CPU the port's ``flash_attention`` takes its
plain version.

Tolerances:
  * float32: rtol = atol = 2e-5 for layers, logits and decode steps,
    whose differences are float32 reassociation only; 1e-5 for rope.
  * bfloat16: atol 6e-2 on outputs of magnitude about 1 (eight bf16 ulps
    at 1.0).  Besides rounding products at other places, the reference
    rounds the softmax weights to bf16 before the PV product, which the
    flash kernel's plain version (the CPU path) does not; the bf16 kernel
    on the card does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import transformer as JT

import repro_torch.configs as TC
from repro_torch.bench import kernels_bench
from repro_torch.carry import model_params_from_reference, tensor_from_array
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

#: the dense configurations: GQA with a QKV bias, qk-norm, non-parametric
#: LayerNorm with tied embeddings, MQA with a gelu FFN
DENSE = ["qwen2-7b", "qwen3-14b", "olmo-1b", "granite-20b"]
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_ATOL = 6e-2
#: reference leaves that init sets to zeros or ones
_CONSTANT_LEAVES = {"bq": 0.0, "bk": 0.0, "bv": 0.0, "q_norm": 1.0,
                    "k_norm": 1.0, "scale": 1.0}


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t).astype(np.float32)


def _cfgs(arch: str, dtype: str = "float32", **kw):
    """The smoke config in both packages; ``kw`` sets shared fields and
    options that only the reference has (``scan_layers``)."""
    ref_only = {k: kw.pop(k) for k in ("scan_layers",) if k in kw}
    return (dataclasses.replace(RC.get_smoke(arch), dtype=dtype, **kw,
                                **ref_only),
            dataclasses.replace(TC.get_smoke(arch), dtype=dtype, **kw))


def _randomize(tree, rng):
    """The numpy parameter tree with every constant-initialised leaf
    (biases, norm scales) replaced by seeded values around its init."""
    if isinstance(tree, dict):
        return {k: (np.asarray(base + 0.2 * rng.standard_normal(v.shape))
                    .astype(v.dtype)
                    if (base := _CONSTANT_LEAVES.get(k)) is not None
                    and not isinstance(v, dict)
                    else _randomize(v, rng)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize(v, rng) for v in tree]
    return tree


def _carried(arch: str, dtype: str = "float32", **kw):
    """Both configs, the reference's parameters (constant leaves
    randomised) and the port's model carried from them, for any family."""
    cfg_j, cfg_t = _cfgs(arch, dtype, **kw)
    tree = _randomize(jax.tree_util.tree_map(
        np.asarray, japi.init(cfg_j, jax.random.PRNGKey(0))),
        np.random.default_rng(7))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return cfg_j, cfg_t, params, model_params_from_reference(tree, cfg_t)


def _x(cfg, shape, seed=1):
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.5) \
        .astype(np.float32)
    xj = jnp.asarray(x).astype(cfg.dtype)
    return xj, tensor_from_array(np.asarray(xj))


# ---------------------------------------------------------------------- #
# layers
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    cfg_j, cfg_t = _cfgs("qwen2-7b", dtype)
    np.testing.assert_allclose(_np(TL.rope_freqs(cfg_t)),
                               _np(JL.rope_freqs(cfg_j)), rtol=1e-6)
    xj, xt = _x(cfg_j, (2, 16, 4, cfg_j.hdim))
    pos = np.arange(32).reshape(2, 16) * 3
    got = TL.apply_rope(xt, torch.from_numpy(pos), TL.rope_freqs(cfg_t))
    want = JL.apply_rope(xj, jnp.asarray(pos), JL.rope_freqs(cfg_j))
    assert got.dtype == xt.dtype
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-2)


@pytest.mark.parametrize("arch", DENSE)
def test_attention_matches_reference(arch):
    cfg_j, cfg_t, params, model = _carried(arch)
    xj, xt = _x(cfg_j, (2, 40, cfg_j.d_model))
    pos = np.broadcast_to(np.arange(40), (2, 40))
    want = JL.attention(cfg_j, params["blocks"][0]["attn"], xj,
                        jnp.asarray(pos))
    with torch.inference_mode():
        got = TL.attention(cfg_t, model.blocks[0].attn, xt,
                           torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_attention_bf16_matches_reference():
    cfg_j, cfg_t, params, model = _carried("qwen2-7b", "bfloat16")
    xj, xt = _x(cfg_j, (2, 40, cfg_j.d_model))
    pos = np.broadcast_to(np.arange(40), (2, 40))
    want = JL.attention(cfg_j, params["blocks"][0]["attn"], xj,
                        jnp.asarray(pos))
    with torch.inference_mode():
        got = TL.attention(cfg_t, model.blocks[0].attn, xt,
                           torch.from_numpy(pos.copy()))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=BF16_ATOL)


@pytest.mark.parametrize("arch,dtype", [("qwen2-7b", "float32"),
                                        ("qwen3-14b", "float32"),
                                        ("granite-20b", "float32"),
                                        ("qwen2-7b", "bfloat16")])
def test_attention_decode_matches_reference(arch, dtype):
    cfg_j, cfg_t, params, model = _carried(arch, dtype)
    rng = np.random.default_rng(2)
    b, S = 2, 12
    xj, xt = _x(cfg_j, (b, 1, cfg_j.d_model))
    shape = (b, S, cfg_j.n_kv_heads, cfg_j.hdim)
    cj = [jnp.asarray(rng.standard_normal(shape), dtype) for _ in range(2)]
    ct = [tensor_from_array(np.asarray(c)) for c in cj]
    pos = np.array([3, 7])
    oj, kj, vj = JL.attention_decode(cfg_j, params["blocks"][1]["attn"], xj,
                                     cj[0], cj[1], jnp.asarray(pos))
    with torch.inference_mode():
        ot, kt, vt = TL.attention_decode(cfg_t, model.blocks[1].attn, xt,
                                         ct[0], ct[1], torch.from_numpy(pos))
    assert kt.data_ptr() == ct[0].data_ptr()         # written in place
    tol = F32_TOL if dtype == "float32" else dict(atol=BF16_ATOL)
    for got, want in ((ot, oj), (kt, kj), (vt, vj)):
        assert got.dtype == tensor_from_array(np.asarray(want)).dtype
        np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_attention_decode_widens_a_narrow_cache():
    """A bf16 cache meeting an fp32 model comes back fp32, as the
    reference's one-hot blend promotes it."""
    cfg_j, cfg_t, params, model = _carried("qwen2-7b")
    xj, xt = _x(cfg_j, (1, 1, cfg_j.d_model))
    cj = jnp.zeros((1, 8, cfg_j.n_kv_heads, cfg_j.hdim), jnp.bfloat16)
    ct = torch.zeros(tuple(cj.shape), dtype=torch.bfloat16)
    oj, kj, _ = JL.attention_decode(cfg_j, params["blocks"][0]["attn"], xj,
                                    cj, cj, jnp.asarray([5]))
    with torch.inference_mode():
        ot, kt, _ = TL.attention_decode(cfg_t, model.blocks[0].attn, xt, ct,
                                        ct.clone(), torch.tensor([5]))
    assert kt.dtype == torch.float32 == tensor_from_array(np.asarray(kj)).dtype
    np.testing.assert_allclose(_np(kt), _np(kj), **F32_TOL)
    np.testing.assert_allclose(_np(ot), _np(oj), **F32_TOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_ffn_matches_reference(act):
    cfg_j, cfg_t, params, model = _carried("qwen2-7b", act=act)
    xj, xt = _x(cfg_j, (2, 9, cfg_j.d_model))
    want = JL.ffn(cfg_j, params["blocks"][2]["ffn"], xj)
    with torch.inference_mode():
        got = TL.ffn(cfg_t, model.blocks[2].ffn, xt)
    assert ("w_gate" in model.blocks[2].ffn) == (act != "gelu")
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


# ---------------------------------------------------------------------- #
# the model, weights carried from the reference
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_serve_steps_match_reference(arch):
    cfg_j, cfg_t, params, model = _carried(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_j.vocab, size=(2, 24))
    lj = JT.forward(cfg_j, params, jnp.asarray(toks))
    with torch.inference_mode():
        lt = TT.forward(cfg_t, model, torch.from_numpy(toks))
    assert tuple(lt.shape) == (2, 24, 512) and lt.dtype == torch.float32
    np.testing.assert_allclose(_np(lt), _np(lj), **F32_TOL)

    cj = JT.init_cache(cfg_j, 2, 16, dtype=jnp.float32)
    ct = TT.init_cache(cfg_t, 2, 16, dtype=torch.float32)
    for t in range(4):
        tok = toks[:, t]
        pos = np.array([t, t + 2])
        aj, cj = JT.serve_step(cfg_j, params, cj, jnp.asarray(tok),
                               jnp.asarray(pos))
        with torch.inference_mode():
            at, ct = TT.serve_step(cfg_t, model, ct, torch.from_numpy(tok),
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(_np(at), _np(aj), **F32_TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(ct[name]), _np(cj[name]),
                                       **F32_TOL)


def test_forward_bf16_matches_reference():
    cfg_j, cfg_t, params, model = _carried("qwen2-7b", "bfloat16")
    toks = np.random.default_rng(1).integers(0, cfg_j.vocab, size=(2, 24))
    lj = JT.forward(cfg_j, params, jnp.asarray(toks))
    with torch.inference_mode():
        lt = TT.forward(cfg_t, model, torch.from_numpy(toks))
    assert lt.dtype == torch.bfloat16
    v = cfg_j.vocab
    np.testing.assert_allclose(_np(lt)[..., :v], _np(lj)[..., :v],
                               atol=BF16_ATOL)


def test_vlm_forward_and_loss_match_reference():
    """llava: patch embeddings prepended; the loss drops their positions."""
    cfg_j, cfg_t, params, model = _carried("llava-next-34b")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg_j.vocab, size=(2, 16))
    labels = rng.integers(0, cfg_j.vocab, size=(2, 16))
    patches = rng.standard_normal((2, cfg_j.n_patches, cfg_j.d_model)) \
        .astype(np.float32)
    lj = JT.forward(cfg_j, params, jnp.asarray(toks),
                    extra_embeds=jnp.asarray(patches))
    batch = {"tokens": torch.from_numpy(toks),
             "patches": torch.from_numpy(patches)}
    lt = make_prefill_step(cfg_t, device="cpu")(model, batch)
    assert tuple(lt.shape) == (2, 16 + cfg_t.n_patches, 512)
    np.testing.assert_allclose(_np(lt), _np(lj), **F32_TOL)
    loss_j = JT.loss_fn(cfg_j, params, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels),
                                        "patches": jnp.asarray(patches)})
    with torch.inference_mode():
        loss_t = tapi.loss_fn(cfg_t, model, dict(
            batch, labels=torch.from_numpy(labels)))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    made = tapi.make_batch(cfg_t, torch.Generator().manual_seed(0), 2, 8)
    assert made["patches"].shape == (2, cfg_t.n_patches, cfg_t.d_model)
    assert made["patches"].dtype == torch.bfloat16


def test_carry_stacked_blocks_equal_listed():
    """scan_layers=True (the full config's vmap-stacked blocks) and a
    list of blocks carry to the same module; OLMo's norms are empty
    subtrees and its head is tied, so the module has neither."""
    cfg_j, cfg_t = _cfgs("olmo-1b", scan_layers=True)
    stacked = jax.tree_util.tree_map(
        np.asarray, JT.init(cfg_j, jax.random.PRNGKey(0)))
    assert isinstance(stacked["blocks"], dict)
    assert stacked["ln_f"] == {} and "head" not in stacked["embed"]
    listed = dict(stacked, blocks=[
        jax.tree_util.tree_map(lambda v, i=i: v[i], stacked["blocks"])
        for i in range(cfg_j.n_layers)])
    a = model_params_from_reference(stacked, cfg_t)
    b = model_params_from_reference(listed, cfg_t)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys() and len(sa) == 1 + 7 * cfg_t.n_layers
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    toks = np.arange(32).reshape(1, 32)
    lj = JT.forward(cfg_j, jax.tree_util.tree_map(jnp.asarray, stacked),
                    jnp.asarray(toks))
    with torch.inference_mode():
        lt = TT.forward(cfg_t, a, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(lt), _np(lj), **F32_TOL)


def test_carry_rejects_a_missing_parameter():
    cfg_j, cfg_t = _cfgs("qwen2-7b")
    tree = jax.tree_util.tree_map(np.asarray,
                                  JT.init(cfg_j, jax.random.PRNGKey(0)))
    del tree["blocks"][1]["attn"]["bk"]
    with pytest.raises(KeyError, match="blocks.1.attn.bk"):
        model_params_from_reference(tree, cfg_t)


def test_loss_matches_reference():
    cfg_j, cfg_t, params, model = _carried("qwen3-14b")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg_j.vocab, size=(2, 20))
    labels = rng.integers(0, cfg_j.vocab, size=(2, 20))
    lj = JT.loss_fn(cfg_j, params, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(labels)})
    with torch.inference_mode():
        lt = tapi.loss_fn(cfg_t, model, {"tokens": torch.from_numpy(toks),
                                         "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)


# ---------------------------------------------------------------------- #
# prefill vs decode, the server, the kernel bench
# ---------------------------------------------------------------------- #
def test_prefill_matches_decode():
    """The port's prefill equals its token-by-token decode, in float32,
    at every position."""
    _, cfg_t, _, model = _carried("qwen2-7b")
    B, S = 2, 20
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg_t.vocab, size=(B, S)))
    logits = make_prefill_step(cfg_t, device="cpu")(model, {"tokens": toks})
    step = make_serve_step(cfg_t, device="cpu")
    cache = tapi.init_cache(cfg_t, B, S, dtype=torch.float32)
    for t in range(S):
        last, cache = step(model, cache, toks[:, t], torch.full((B,), t))
        np.testing.assert_allclose(_np(last), _np(logits[:, t]), **F32_TOL)


def _prompts(vocab, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=rng.integers(4, 12)).tolist()
            for _ in range(n)]


def _serve_both(dtype: str, arch: str = "qwen2-7b"):
    """The five prompts through the reference's server and the port's,
    on carried weights, with the model and its KV cache in ``dtype``;
    returns both servers and their requests in submission order."""
    cfg_j, cfg_t = _cfgs(arch, dtype)
    js = jserve.Server(cfg_j, batch=2, max_len=64)
    # The reference's prompt prefill hands ``jnp.asarray(self.pos)`` to a
    # step that JAX dispatches asynchronously and then increments
    # ``self.pos`` in place; on the CPU that array can share the numpy
    # buffer, so the step sometimes reads the next position and the
    # reference's tokens change from run to run.  Each step here finishes
    # before the server goes on.
    step = js._step
    js._step = lambda *args: jax.block_until_ready(step(*args))
    js.cache = japi.init_cache(cfg_j, 2, 64, dtype=jnp.dtype(dtype))
    model = model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, js.params), cfg_t)
    ts = tserve.Server(cfg_t, batch=2, max_len=64, params=model,
                       device="cpu")
    ts.cache = tapi.init_cache(cfg_t, 2, 64, dtype=getattr(torch, dtype))
    for rid, prompt in enumerate(_prompts(cfg_j.vocab)):
        js.submit(jserve.Request(rid, prompt, 6))
        ts.submit(tserve.Request(rid, list(prompt), 6))
    jreqs, treqs = list(js.queue), list(ts.queue)
    js.drain()
    ts.drain()
    return js, ts, jreqs, treqs


def _reference_logits(js, req, dtype: str):
    """The reference model's logits before each token it generated for
    ``req``: its prompt and tokens teacher-forced through its decode
    step, one sequence at a time."""
    cache = japi.init_cache(js.cfg, 1, js.max_len, dtype=jnp.dtype(dtype))
    seq = list(req.prompt) + list(req.out)
    rows = []
    for t in range(len(seq) - 1):
        logits, cache = js._step(js.params, cache,
                                 jnp.asarray([seq[t]], jnp.int32),
                                 jnp.asarray([t], jnp.int32))
        if t >= len(req.prompt) - 1:
            rows.append(np.asarray(logits[0], np.float32))
    return rows


def _assert_same_tokens(js, jreqs, treqs, dtype: str, atol: float):
    """Greedy tokens equal, except that the port may take another token
    where the reference's top two logits are within ``atol`` of each
    other (a near-tie that the order of a reduction on either side can
    flip); the rest of that request then follows another history and is
    not compared."""
    for rj, rt in zip(jreqs, treqs):
        assert rt.done and len(rt.out) == len(rj.out) == 6
        if rt.out == rj.out:
            continue
        t = next(i for i, (a, b) in enumerate(zip(rj.out, rt.out))
                 if a != b)
        row = _reference_logits(js, rj, dtype)[t]
        top = float(row.max())
        assert top - float(np.sort(row)[-2]) <= atol, (rt.rid, t)
        assert top - float(row[rt.out[t]]) <= atol, (rt.rid, t)


def test_server_matches_reference_server():
    """In float32 (weights, activations and KV cache) the two servers
    hold logits to F32_TOL, so greedy tokens agree but for near-ties
    within it; in bfloat16, but for near-ties within BF16_ATOL."""
    for dtype, atol in (("float32", F32_TOL["atol"]),
                        ("bfloat16", BF16_ATOL)):
        js, ts, jreqs, treqs = _serve_both(dtype)
        _assert_same_tokens(js, jreqs, treqs, dtype, atol)
        assert list(ts.pos) == list(js.pos)


def test_server_drains_with_its_own_weights():
    cfg = TC.get_smoke("qwen2-7b")
    server = tserve.Server(cfg, batch=3, max_len=32, device="cpu")
    reqs = [tserve.Request(i, p, 4) for i, p in
            enumerate(_prompts(cfg.vocab, n=4, seed=1))]
    for r in reqs:
        server.submit(r)
    server.drain()
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert all(0 <= t < cfg.vocab for r in reqs for t in r.out)
    assert server.cache["k"].dtype == torch.bfloat16


def test_kernels_bench_rows_within_limits(monkeypatch, capsys):
    rows = kernels_bench.run(device="cpu", reps=1)
    assert [r.name for r in rows] == [
        "kernels/flash_attention/plain", "kernels/flash_attention/torch_ref",
        "kernels/block_sparse_matmul/plain", "kernels/ssd_chunk/plain",
        "kernels/intersect_sorted/plain", "kernels/merge_sorted/plain",
        "kernels/spmspm_coiter/vector"]
    for r in rows:
        assert r.err <= r.limit and r.us_per_call > 0, r
    monkeypatch.setattr("sys.argv", ["kernels_bench", "--device", "cpu"])
    assert kernels_bench.main() == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,err" and len(out) == 8
