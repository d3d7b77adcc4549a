"""The port's Mamba2 path against the reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
model weights come from the reference's ``init`` and are carried into
the port with ``model_params_from_reference``.  On the CPU the port's
``ssd_chunk`` takes its plain version, and the reference's Pallas
kernel runs in interpret mode, as its own tests run it.

Tolerances:
  * float32: rtol = atol = 2e-4 for the SSD stages (the reference's own
    kernel-vs-oracle tolerance, tests/test_kernels.py); 2e-5 for whole
    layers, logits and decode steps, whose differences are float32
    reassociation only (measured about 1.5e-6 on logits of magnitude 1).
  * bfloat16: atol 6e-2 on logits of magnitude about 1 (eight bf16 ulps
    at 1.0).  The two frameworks round products and convolutions to
    bf16 at different places, so single-ulp differences (0.4%) enter
    every layer and carry through the residual stream.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.kernels import ref as jref
from repro.kernels.ssd_chunk import ssd_chunk as jax_ssd_chunk
from repro.launch import serve as jserve
from repro.models import ssm as JS

import repro_torch.configs as TC
from repro_torch.carry import model_params_from_reference, tensor_from_array
from repro_torch.kernels import ssd_chunk, ssd_chunk_plain
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import api as tapi
from repro_torch.models import ssm as TS

ARCH = "mamba2-1.3b"
#: (B, nc, l, H, P, N), the reference's SSD_SHAPES (tests/test_kernels.py)
SSD_SHAPES = [
    (1, 2, 64, 2, 32, 16),
    (2, 3, 128, 4, 64, 32),
    (1, 1, 256, 8, 64, 128),     # the production chunk config
]
TOL = dict(rtol=2e-4, atol=2e-4)
F32_MODEL_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_LOGIT_ATOL = 6e-2


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_exp():
    """The first large multithreaded ``torch.exp`` of a process can come
    back about 1e-4 off (MKL vector math, seen on an AMX CPU in 4 of
    126 fresh processes; every later call agrees).  One throwaway
    call keeps the comparisons below to their tolerances."""
    torch.exp(torch.rand(1 << 22))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t).astype(np.float32)


def _chunk_inputs(B, nc, l, H, P, N, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, nc, l, H, P)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((B, H, nc, l))) * 0.1).astype(np.float32)
    b = rng.standard_normal((B, nc, l, N)).astype(np.float32)
    c = rng.standard_normal((B, nc, l, N)).astype(np.float32)
    return x, a, b, c


def _cfgs(dtype: str, **ref_kw):
    """The smoke config in both packages; ``ref_kw`` sets options that only
    the reference has (``scan_layers``)."""
    return (dataclasses.replace(RC.get_smoke(ARCH), dtype=dtype, **ref_kw),
            dataclasses.replace(TC.get_smoke(ARCH), dtype=dtype))


def _carried(dtype: str):
    cfg_j, cfg_t = _cfgs(dtype)
    params = JS.init(cfg_j, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return cfg_j, cfg_t, params, model_params_from_reference(tree, cfg_t)


# ---------------------------------------------------------------------- #
# configs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_configs_match_reference(arch):
    assert TC.ARCH_IDS == RC.ARCH_IDS
    for get in ("get", "get_smoke"):
        want = dataclasses.asdict(getattr(RC, get)(arch))
        got = dataclasses.asdict(getattr(TC, get)(arch))
        # the reference's layer-scan and kernel switches are not carried
        # (remat is, with the training path); every other field is equal
        assert set(want) - set(got) == {"scan_layers", "use_kernels"}
        assert got == {k: want[k] for k in got}
    from repro.configs.base import param_count as jcount
    from repro_torch.configs.base import param_count as tcount
    assert tcount(TC.get(arch)) == jcount(RC.get(arch))


# ---------------------------------------------------------------------- #
# the ssd_chunk stage
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("B,nc,l,H,P,N", SSD_SHAPES)
def test_ssd_chunk_plain_matches_reference(B, nc, l, H, P, N):
    x, a, b, c = _chunk_inputs(B, nc, l, H, P, N)
    got = _np(ssd_chunk_plain(_t(x), _t(a), _t(b), _t(c)))
    kernel = jax_ssd_chunk(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                           jnp.asarray(c), interpret=True)
    oracle = jref.ssd_chunk_ref(jnp.asarray(x), jnp.asarray(a),
                                jnp.asarray(b), jnp.asarray(c))
    np.testing.assert_allclose(got, _np(kernel), **TOL)
    np.testing.assert_allclose(got, _np(oracle), **TOL)


@pytest.mark.parametrize("B,nc,l,H,P,N", SSD_SHAPES)
def test_ssd_chunk_plain_matches_segsum_form(B, nc, l, H, P, N):
    """The kernel's decay (a difference of cumulative sums) against the
    port's own ``_segsum`` (a sum over (j, i])."""
    x, a, b, c = (_t(v) for v in _chunk_inputs(B, nc, l, H, P, N, seed=7))
    lmask = torch.exp(TS._segsum(a))
    g = torch.einsum("bcln,bcsn->bcls", c, b)
    want = torch.einsum("bcls,bhcls,bcshp->bclhp", g, lmask, x)
    np.testing.assert_allclose(_np(ssd_chunk_plain(x, a, b, c)), _np(want),
                               **TOL)


def test_ssd_chunk_wrapper_on_cpu_takes_plain():
    x, a, b, c = (_t(v) for v in _chunk_inputs(1, 2, 64, 2, 32, 16))
    ssd_chunk.launches = 0
    got = ssd_chunk(x, a, b, c)
    assert ssd_chunk.launches == 0
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert torch.equal(got, ssd_chunk_plain(x, a, b, c))
    # the meta device (a dry run's route): an empty fp32 y of x's shape,
    # no launch and no plain version
    ym = ssd_chunk(*(t.to("meta") for t in (x, a, b, c)))
    assert (ym.device.type, ym.shape, ym.dtype) == ("meta", x.shape,
                                                    torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk(x.permute(4, 3, 2, 1, 0).contiguous()
                  .permute(4, 3, 2, 1, 0), a, b, c)
    with pytest.raises(ValueError, match="float32"):
        ssd_chunk(x, a.double(), b, c)
    with pytest.raises(ValueError, match="shapes disagree"):
        ssd_chunk(x, a, b[:, :1], c)
    assert ssd_chunk.launches == 0


@pytest.mark.parametrize("init_state", [False, True], ids=["zero", "given"])
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["jnp-cascade", "pallas-interpret"])
def test_ssd_matches_reference(init_state, use_kernel):
    rng = np.random.default_rng(4)
    B, S, H, P, N, chunk = 2, 128, 2, 32, 16, 64
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((B, S, H))) * 0.1).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32) \
        if init_state else None
    yj, fj = JS.ssd(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                    jnp.asarray(c), chunk,
                    init_state=None if s0 is None else jnp.asarray(s0),
                    use_kernel=use_kernel)
    yt, ft = TS.ssd(_t(x), _t(a), _t(b), _t(c), chunk,
                    init_state=None if s0 is None else _t(s0))
    np.testing.assert_allclose(_np(yt), _np(yj), **TOL)
    np.testing.assert_allclose(_np(ft), _np(fj), **TOL)


# ---------------------------------------------------------------------- #
# layers and the model, weights carried from the reference
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_layer_matches_reference(dtype):
    cfg_j, cfg_t, params, model = _carried(dtype)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 48, cfg_j.d_model)) * 0.5) \
        .astype(np.float32)
    xj = jnp.asarray(x).astype(cfg_j.dtype)
    yj = JS.mamba_layer(cfg_j, params["blocks"][0]["mamba"], xj)
    with torch.inference_mode():
        yt = TS.mamba_layer(cfg_t, model.blocks[0].mamba,
                            tensor_from_array(np.asarray(xj)))
    assert yt.dtype == TS.L._dtype(cfg_t)
    if dtype == "float32":
        np.testing.assert_allclose(_np(yt), _np(yj), **F32_MODEL_TOL)
    else:
        np.testing.assert_allclose(_np(yt), _np(yj), atol=BF16_LOGIT_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_serve_steps_match_reference(dtype):
    cfg_j, cfg_t, params, model = _carried(dtype)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_j.vocab, size=(2, 64))
    lj = JS.forward(cfg_j, params, jnp.asarray(toks))
    with torch.inference_mode():
        lt = TS.forward(cfg_t, model, torch.from_numpy(toks))
    assert tuple(lt.shape) == (2, 64, 512) and lt.dtype == TS.L._dtype(cfg_t)
    v = cfg_j.vocab
    if dtype == "float32":
        np.testing.assert_allclose(_np(lt), _np(lj), **F32_MODEL_TOL)
    else:
        np.testing.assert_allclose(_np(lt)[..., :v], _np(lj)[..., :v],
                                   atol=BF16_LOGIT_ATOL)

    cj = JS.init_cache(cfg_j, 2, 64)
    ct = TS.init_cache(cfg_t, 2, 64)
    for t in range(4):
        tok = toks[:, t]
        aj, cj = JS.serve_step(cfg_j, params, cj, jnp.asarray(tok),
                               jnp.full((2,), t, jnp.int32))
        with torch.inference_mode():
            at, ct = TS.serve_step(cfg_t, model, ct, torch.from_numpy(tok),
                                   torch.full((2,), t))
        assert ct["conv"].dtype == tensor_from_array(
            np.asarray(cj["conv"])).dtype
        if dtype == "float32":
            np.testing.assert_allclose(_np(at), _np(aj), **F32_MODEL_TOL)
            np.testing.assert_allclose(_np(ct["ssm"]), _np(cj["ssm"]),
                                       **F32_MODEL_TOL)
            np.testing.assert_allclose(_np(ct["conv"]), _np(cj["conv"]),
                                       **F32_MODEL_TOL)
        else:
            np.testing.assert_allclose(_np(at)[:, :v], _np(aj)[:, :v],
                                       atol=BF16_LOGIT_ATOL)
            np.testing.assert_allclose(_np(ct["ssm"]), _np(cj["ssm"]),
                                       atol=BF16_LOGIT_ATOL)


def test_loss_matches_reference():
    cfg_j, cfg_t, params, model = _carried("float32")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg_j.vocab, size=(2, 32))
    labels = rng.integers(0, cfg_j.vocab, size=(2, 32))
    lj = JS.loss_fn(cfg_j, params, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(labels)})
    with torch.inference_mode():
        lt = tapi.loss_fn(cfg_t, model, {"tokens": torch.from_numpy(toks),
                                         "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)


def test_padded_vocab_logits_are_masked():
    _, cfg_t, _, model = _carried("float32")
    cfg_t = dataclasses.replace(cfg_t, vocab=500)
    with torch.inference_mode():
        logits = TS.forward(cfg_t, model, torch.zeros(1, 16, dtype=torch.long))
    assert logits.shape[-1] == 512
    assert bool((logits[..., 500:] == -1e30).all())
    assert bool((logits[..., :500] > -1e29).all())


def test_carry_stacked_blocks_equal_listed():
    """scan_layers=True (the full config's vmap-stacked blocks) and a
    list of blocks carry to the same module."""
    cfg_j, cfg_t = _cfgs("float32", scan_layers=True)
    stacked = jax.tree_util.tree_map(
        np.asarray, JS.init(cfg_j, jax.random.PRNGKey(0)))
    assert isinstance(stacked["blocks"], dict)
    listed = dict(stacked, blocks=[
        jax.tree_util.tree_map(lambda v, i=i: v[i], stacked["blocks"])
        for i in range(cfg_j.n_layers)])
    a = model_params_from_reference(stacked, cfg_t)
    b = model_params_from_reference(listed, cfg_t)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys() and len(sa) == 1 + 9 * cfg_t.n_layers + 1
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    toks = np.arange(32).reshape(1, 32)
    lj = JS.forward(cfg_j, jax.tree_util.tree_map(jnp.asarray, stacked),
                    jnp.asarray(toks))
    with torch.inference_mode():
        lt = TS.forward(cfg_t, a, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(lt), _np(lj), **F32_MODEL_TOL)


def test_carry_bf16_is_bit_for_bit():
    rng = np.random.default_rng(9)
    arr = rng.standard_normal((7, 33)).astype(ml_dtypes.bfloat16)
    arr[0, :4] = np.array([np.inf, -np.inf, np.nan, -0.0],
                          dtype=ml_dtypes.bfloat16)
    t = tensor_from_array(arr)
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == arr.shape
    assert np.array_equal(t.view(torch.int16).numpy(),
                          arr.view(np.int16))
    _, cfg_t, params, model = _carried("bfloat16")
    want = np.asarray(params["blocks"][1]["mamba"]["w_in"])
    got = model.blocks[1].mamba.w_in
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def test_carry_rejects_wrong_dtype():
    cfg_j, cfg_t = _cfgs("bfloat16")
    tree = jax.tree_util.tree_map(np.asarray,
                                  JS.init(cfg_j, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="reference torch.bfloat16"):
        model_params_from_reference(tree, dataclasses.replace(
            cfg_t, dtype="float32"))


# ---------------------------------------------------------------------- #
# prefill vs decode, the server, devices
# ---------------------------------------------------------------------- #
def test_prefill_matches_decode():
    """The port's chunked prefill equals its token-by-token decode (the
    reference's test_ssd_prefill_matches_decode, in float32, for one
    layer and for the whole model's last-position logits)."""
    _, cfg_t, _, model = _carried("float32")
    torch.manual_seed(0)
    B, S = 2, 48                     # three chunks of 16
    x = torch.randn(B, S, cfg_t.d_model) * 0.1
    pr = model.blocks[0].mamba
    with torch.inference_mode():
        full = TS.mamba_layer(cfg_t, pr, x)
        ss, cs = TS.init_layer_cache(cfg_t, B)
        outs = []
        for t in range(S):
            y, ss, cs = TS.mamba_decode(cfg_t, pr, x[:, t:t + 1], ss, cs)
            outs.append(y)
    np.testing.assert_allclose(_np(full), _np(torch.cat(outs, 1)),
                               rtol=2e-4, atol=2e-4)

    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg_t.vocab, size=(B, S)))
    prefill = make_prefill_step(cfg_t, device="cpu")
    step = make_serve_step(cfg_t, device="cpu")
    logits = prefill(model, {"tokens": toks})
    cache = tapi.init_cache(cfg_t, B, S, dtype=torch.float32)
    for t in range(S):
        last, cache = step(model, cache, toks[:, t], torch.full((B,), t))
    np.testing.assert_allclose(_np(last), _np(logits[:, -1]),
                               rtol=2e-4, atol=2e-4)


def _prompts(vocab, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=rng.integers(4, 12)).tolist()
            for _ in range(n)]


def test_server_matches_reference_server():
    cfg_j, cfg_t = _cfgs("float32")
    js = jserve.Server(cfg_j, batch=2, max_len=64)
    model = model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, js.params), cfg_t)
    ts = tserve.Server(cfg_t, batch=2, max_len=64, params=model,
                       device="cpu")
    for rid, prompt in enumerate(_prompts(cfg_j.vocab)):
        js.submit(jserve.Request(rid, prompt, 6))
        ts.submit(tserve.Request(rid, list(prompt), 6))
    jreqs, treqs = list(js.queue), list(ts.queue)
    js.drain()
    ts.drain()
    for rj, rt in zip(jreqs, treqs):
        assert rt.done and len(rt.out) == 6
        assert rt.out == rj.out, rt.rid
    assert list(ts.pos) == list(js.pos)


def test_server_drains_with_its_own_weights():
    cfg = TC.get_smoke(ARCH)
    server = tserve.Server(cfg, batch=3, max_len=32, device="cpu")
    reqs = [tserve.Request(i, p, 4) for i, p in
            enumerate(_prompts(cfg.vocab, n=4, seed=1))]
    for r in reqs:
        server.submit(r)
    server.drain()
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert all(0 <= t < cfg.vocab for r in reqs for t in r.out)
    assert tapi.param_bytes(server.params) == sum(
        p.numel() * p.element_size() for p in server.params.parameters())


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get_smoke(ARCH)
    for make in (lambda: tserve.Server(cfg),
                 lambda: make_prefill_step(cfg),
                 lambda: make_serve_step(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    tserve.Server(cfg, batch=1, max_len=8, device="cpu")
    make_prefill_step(cfg, device="cpu")


@pytest.mark.parametrize("arch", ["grok-1-314b", "qwen2-moe-a2.7b",
                                  "jamba-1.5-large-398b", "whisper-small"])
def test_other_families_raise(arch, monkeypatch):
    """The moe, hybrid and encdec families raise without a card unless
    the CPU is asked for, as this family does; on the CPU their prefill
    gives finite logits."""
    cfg = TC.get_smoke(arch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tserve.Server(cfg),
                 lambda: make_prefill_step(cfg),
                 lambda: make_serve_step(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    params = tapi.init(cfg, torch.Generator().manual_seed(0))
    batch = tapi.make_batch(cfg, torch.Generator().manual_seed(1), 1, 32)
    logits = make_prefill_step(cfg, device="cpu")(params, batch)
    assert logits.shape == (1, 32, 512)
    assert bool(torch.isfinite(logits[..., :cfg.vocab]).all())


def test_seeded_init_is_deterministic():
    cfg = TC.get_smoke(ARCH)
    a = tapi.init(cfg, torch.Generator().manual_seed(5))
    b = tapi.init(cfg, torch.Generator().manual_seed(5))
    c = tapi.init(cfg, torch.Generator().manual_seed(6))
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.blocks[0].mamba.w_in, c.blocks[0].mamba.w_in)
    batch = tapi.make_batch(cfg, torch.Generator().manual_seed(0), 2, 16)
    assert batch["tokens"].shape == (2, 16)
    assert int(batch["tokens"].max()) < cfg.vocab
