"""The port's dry run, step counter and roofline against the reference and
against hand counts, on the CPU.

  * ``input_specs``: the shapes and dtypes of the reference's
    ``ShapeDtypeStruct``s (unscanned layout, names through
    ``carry._reference_flat``) for every arch at full width and every
    cell, as ``meta`` tensors (nothing allocated);
  * ``StepCost``: on ``meta`` its operations equal a count by hand,
    exactly: the products of each family's smoke model (forward; under
    remat the blocks' forward again up to their last saved tensor; the
    backward's two products a product, none for a product the loss does
    not reach) plus each kernel's own count; and they lie below the
    reference's XLA count on the four smoke cells (the ratios are stated
    there);
  * the probes: their extrapolation equals a whole walk;
  * collectives, roofline terms, ``model_flops`` and the dry run's
    records against the reference's;
  * the kernels' ``meta`` routes, and ``chip_smoke.py``'s bounds at
    ``PERF.md`` §6's shapes read from the kernels' own counts.
"""
import dataclasses
import functools
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import repro.configs as RC
from repro.configs.base import SHAPES as RSHAPES
from repro.core import metrics as RM
from repro.launch import dryrun as RD
from repro.launch import hlo_analysis as RH
from repro.launch import roofline as RR
from repro.launch import steps as RST

import repro_torch.configs as C
from repro_torch.carry import _reference_flat
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.core import metrics as M
from repro_torch.kernels import (MODEL_KERNELS, block_sparse_matmul,
                                 flash_attention, flash_attention_bwd,
                                 ssd_chunk, ssd_chunk_bwd)
from repro_torch.kernels import meta as kmeta
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import padded_vocab

ROOT = Path(__file__).resolve().parents[1]
FA = sys.modules["repro_torch.kernels.flash_attention"]
FB = sys.modules["repro_torch.kernels.flash_attention_bwd"]
SC = sys.modules["repro_torch.kernels.ssd_chunk"]
SB = sys.modules["repro_torch.kernels.ssd_chunk_bwd"]
META_MESH = make_mesh(1, 1, device="meta")
#: one smoke config a family
FAMILIES = {"dense": "qwen2-7b", "vlm": "llava-next-34b",
            "moe": "qwen2-moe-a2.7b", "ssm": "mamba2-1.3b",
            "hybrid": "jamba-1.5-large-398b", "encdec": "whisper-small"}


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "") if isinstance(t, torch.Tensor) \
        else np.dtype(t.dtype).name


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ---------------------------------------------------------------------- #
# input specs
# ---------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _ref_specs(arch):
    cfg = dataclasses.replace(RC.get(arch), scan_layers=False)
    from repro.optim import optimizers as RO
    return cfg, RST.param_specs(cfg), RST.opt_state_specs(
        cfg, RO.for_config(cfg))


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    rcfg, rparams, rstate = _ref_specs(arch)
    cfg = C.get(arch)
    want_params = {k: (tuple(v.shape), _dtype_name(v))
                   for k, v in _reference_flat(rparams, rcfg).items()}
    for name, shape in SHAPES.items():
        specs = ST.input_specs(cfg, shape)
        # the reference's input_specs, its parameter and state specs
        # evaluated once an arch
        rshape = RSHAPES[name]
        ref = {"params": rparams}
        if shape.kind == "train":
            ref.update(opt_state=rstate,
                       batch=RST.batch_specs(rcfg, rshape))
        elif shape.kind == "prefill":
            ref["batch"] = RST.batch_specs(rcfg, rshape)
        else:
            b = rshape.global_batch
            ref.update(cache=RST.cache_specs(rcfg, b, rshape.seq_len),
                       token=jax.ShapeDtypeStruct((b,), np.int32),
                       pos=jax.ShapeDtypeStruct((b,), np.int32))
        assert set(specs) == set(ref)
        got_params = {n: (tuple(p.shape), _dtype_name(p))
                      for n, p in specs["params"].named_parameters()}
        assert got_params == want_params
        for key in set(ref) - {"params", "opt_state"}:
            got = specs[key] if isinstance(specs[key], dict) \
                else {"": specs[key]}
            want = ref[key] if isinstance(ref[key], dict) else {"": ref[key]}
            assert {k: (tuple(v.shape), _dtype_name(v))
                    for k, v in got.items()} == \
                {k: (tuple(v.shape), _dtype_name(v)) for k, v in want.items()}
        if "opt_state" in ref:
            got = specs["opt_state"]
            assert (tuple(got["step"].shape), _dtype_name(got["step"])) == \
                (tuple(rstate["step"].shape), _dtype_name(rstate["step"]))
            for key in set(rstate) - {"step"}:
                want = {k: (tuple(v.shape), _dtype_name(v)) for k, v in
                        _reference_flat(rstate[key], rcfg).items()}
                assert {k: (tuple(v.shape), _dtype_name(v)) for k, v in
                        _flat(got[key]).items()} == want
        # nothing is allocated: every tensor is a meta tensor
        leaves = list(specs["params"].parameters()) + [
            t for k, v in specs.items() if k != "params"
            for t in (_flat(v).values() if isinstance(v, dict) else [v])]
        assert all(t.device.type == "meta" for t in leaves)


# ---------------------------------------------------------------------- #
# the step counter against a count by hand
# ---------------------------------------------------------------------- #
def _mm(m, k, n):
    return 2 * m * k * n


def _attn_proj(cfg, tq, tkv):
    """q and o over ``tq`` tokens, k and v over ``tkv``."""
    d, h = cfg.d_model, cfg.hdim
    return 2 * _mm(tq, d, cfg.n_heads * h) + 2 * _mm(tkv, d,
                                                     cfg.n_kv_heads * h)


def _ffn(cfg, t, f):
    return _mm(t, cfg.d_model, f) * (3 if cfg.act in ("swiglu", "geglu")
                                     else 2)


def _flash(cfg, b, sq, sk, causal):
    shape = (b, cfg.n_heads, cfg.n_kv_heads, sq, sk, cfg.hdim)
    return FA.flops(shape, causal), FB.flops(shape, causal)


def _moe(cfg, t):
    m = cfg.moe
    g, cap = moe_mod.dispatch_shape(cfg, t)
    f = m.d_expert or cfg.d_ff
    return _mm(t, cfg.d_model, m.n_experts) + \
        m.n_experts * _ffn(cfg, g * cap, f) + m.n_shared * _ffn(cfg, t, f)


def _mamba(cfg, b, s):
    """One Mamba layer's products and its ``ssd_chunk`` call's shape."""
    d_in, nh, p, n, conv = ssm_mod.dims(cfg)
    t = b * s
    prods = _mm(t, cfg.d_model, 2 * d_in + 2 * n + nh) \
        + 2 * t * cfg.ssm.d_conv * conv \
        + 2 * _mm(t, n, nh * p) + _mm(t, d_in, cfg.d_model)
    l = cfg.ssm.chunk
    return prods, (b, s // l, l, nh, p, n)


def count_by_hand(cfg, b, s, kind):
    """The step's operations: its products and its kernels' counts.

    Under remat each block's forward runs again in the backward, up to
    the last tensor its backward saved (torch's non-reentrant checkpoint
    stops there): a dense, Mamba or encoder-decoder block's last
    product, its output projection, is not run again; a MoE block (or a
    hybrid superblock, which ends in one) saves tensors of its
    auxiliary loss, after all its products.  The backward takes two
    products a product, none for the decoder's cross-attention k and v
    projections of its own input, which the encoder's replace (``dead``:
    they reach no loss)."""
    fam = cfg.family
    blocks = dead = tail = kf = kb = 0
    t = b * s
    if fam in ("dense", "vlm", "moe"):
        sx = s + cfg.n_patches
        tx = b * sx
        fa, fb = _flash(cfg, b, sx, sx, True)
        ffn = _moe(cfg, tx) if fam == "moe" else _ffn(cfg, tx, cfg.d_ff)
        blocks = cfg.n_layers * (_attn_proj(cfg, tx, tx) + ffn)
        if fam != "moe":
            tail = cfg.n_layers * _mm(tx, cfg.d_ff, cfg.d_model)
        kf, kb = cfg.n_layers * fa, cfg.n_layers * fb
        head = _mm(tx, cfg.d_model, padded_vocab(cfg))
    elif fam == "ssm":
        prods, shape = _mamba(cfg, b, s)
        blocks = cfg.n_layers * prods
        tail = cfg.n_layers * _mm(t, ssm_mod.dims(cfg)[0], cfg.d_model)
        kf, kb = cfg.n_layers * SC.flops(shape), cfg.n_layers * SB.flops(shape)
        head = _mm(t, cfg.d_model, padded_vocab(cfg))
    elif fam == "hybrid":
        prods, shape = _mamba(cfg, b, s)
        fa, fb = _flash(cfg, b, s, s, True)
        for i in range(cfg.hybrid_block):
            if i == cfg.hybrid_attn_idx:
                blocks += _attn_proj(cfg, t, t)
                kf, kb = kf + fa, kb + fb
            else:
                blocks += prods
                kf, kb = kf + SC.flops(shape), kb + SB.flops(shape)
            blocks += _moe(cfg, t) if i % cfg.moe_every == \
                cfg.moe_every - 1 else _ffn(cfg, t, cfg.d_ff)
        n = cfg.n_layers // cfg.hybrid_block
        blocks, kf, kb = n * blocks, n * kf, n * kb
        head = _mm(t, cfg.d_model, padded_vocab(cfg))
    else:                                                   # encdec
        tf = b * cfg.enc_frames
        ea, eb = _flash(cfg, b, cfg.enc_frames, cfg.enc_frames, False)
        sa, sb = _flash(cfg, b, s, s, True)
        xa, xb = _flash(cfg, b, s, cfg.enc_frames, False)
        kv = 2 * _mm(t, cfg.d_model, cfg.n_kv_heads * cfg.hdim)
        blocks = cfg.enc_layers * (_attn_proj(cfg, tf, tf)
                                   + _ffn(cfg, tf, cfg.d_ff)) + \
            cfg.n_layers * (_attn_proj(cfg, t, t) + _attn_proj(cfg, t, tf)
                            + kv + _ffn(cfg, t, cfg.d_ff))
        dead = cfg.n_layers * kv
        tail = cfg.enc_layers * _mm(tf, cfg.d_ff, cfg.d_model) + \
            cfg.n_layers * _mm(t, cfg.d_ff, cfg.d_model)
        kf = cfg.enc_layers * ea + cfg.n_layers * (sa + xa)
        kb = cfg.enc_layers * eb + cfg.n_layers * (sb + xb)
        head = _mm(t, cfg.d_model, padded_vocab(cfg))
    if kind == "prefill":
        return blocks + head + kf
    return (2 * blocks - tail) + head + 2 * (blocks - dead + head) + \
        2 * kf + kb


def _smoke(fam):
    return C.get_smoke(FAMILIES[fam])


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_counted_flops_equal_the_count_by_hand(fam, kind):
    cfg = _smoke(fam)
    shape = ShapeSpec("t", 64, 2, kind)
    before = [k.launches for k in MODEL_KERNELS]
    cost = D.walk(cfg, shape, META_MESH)
    assert cost.flops == count_by_hand(cfg, 2, 64, kind)
    assert [k.launches for k in MODEL_KERNELS] == before     # meta: no launch
    want = {"flash_attention", "ssd_chunk"} & {
        "flash_attention" if fam != "ssm" else "",
        "ssd_chunk" if fam in ("ssm", "hybrid") else ""}
    if kind == "train":
        want |= {k + "_bwd" for k in want}
    assert set(cost.kernel_calls) == want
    assert cost.hbm_bytes > 0 and cost.collectives.total_wire_bytes == 0


def test_grouped_conv_weight_gradient_is_counted_once():
    """torch's formula counts a depthwise conv's weight gradient against
    every pair of channels; the counter's repair gives 2 B S K C."""
    x = torch.randn(2, 12, 20, requires_grad=True)
    w = torch.randn(12, 1, 4, requires_grad=True)
    with CA.StepCost() as cost:
        y = torch.nn.functional.conv1d(x, w, groups=12)
        torch.autograd.grad(y.sum(), (x, w))
    fwd = 2 * 2 * 17 * 12 * 4
    assert cost.flops == 3 * fwd


#: the port's count over the reference's XLA cost_analysis FLOPs at 2 x
#: 64 (an Auto-axis 1 x 1 mesh, since the reference's own mesh has
#: Explicit axes that its ``constrain`` refuses; computed in the test),
#: as measured here.  The port counts the flash kernels' causal half of
#: the scores, in the forward, the recomputation and the backward; the
#: reference's masked attention computes the whole square, and XLA adds
#: the elementwise work (softmax, norms, AdamW), about a tenth of its
#: count at these widths of 128.  So the prefills sit above 0.9 and the
#: train steps below it.
XLA_CELLS = [("olmo-1b", "prefill", 0.9210), ("olmo-1b", "train", 0.8716),
             ("qwen2-7b", "prefill", 0.9158), ("qwen2-7b", "train", 0.8608)]


@pytest.mark.parametrize("arch,kind,ratio", XLA_CELLS)
def test_counted_flops_against_xla(arch, kind, ratio):
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    shape = RSHAPES["train_4k"].__class__("t", 64, 2, kind)
    _, compiled = RD._lower_compile(RC.get_smoke(arch), shape, mesh)
    xla = RD._cell_costs(compiled)["flops"]
    got = D.walk(C.get_smoke(arch), ShapeSpec("t", 64, 2, kind),
                 META_MESH).flops
    assert 0.85 <= got / xla <= 1.0
    assert abs(got / xla - ratio) < 1e-3


# ---------------------------------------------------------------------- #
# the probes, the records, the roofline
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_probes_equal_a_whole_walk(fam):
    cfg = _smoke(fam)
    if fam == "encdec":
        with pytest.raises(ValueError, match="pairs"):
            D.probe_config(cfg, 1)
        cfg = dataclasses.replace(cfg, enc_layers=cfg.n_layers)
    shape = ShapeSpec("t", 32, 2, "train")
    whole = D.step_costs(cfg, shape, META_MESH, probes=False)
    assert D.step_costs(cfg, shape, META_MESH) == whole
    assert D.n_units(cfg) == (1 if fam == "hybrid" else cfg.n_layers)


def test_run_cell_records_and_the_roofline_table(tmp_path):
    rec = D.run_cell("olmo-1b", "long_500k", card="H100 80GB HBM3",
                     directory=tmp_path, verbose=False)
    ref = RD.run_cell("olmo-1b", "long_500k", False, save=False,
                      verbose=False)
    assert rec["status"] == ref["status"] == "skipped"
    assert rec["reason"] == ref["reason"]
    rec = D.run_cell("olmo-1b", "decode_32k", card="H100 80GB HBM3",
                     directory=tmp_path, verbose=False)
    assert rec["status"] == "ok" and rec["chips"] == 1
    assert rec["argument_bytes"] > rec["memory_bytes"] == 80e9
    assert not rec["fits"]
    on_disk = json.loads((tmp_path / "olmo-1b__decode_32k__h100_1x1.json")
                         .read_text())
    assert on_disk == rec
    cells = R.full_table(directory=tmp_path)
    assert [(c.arch, c.shape, c.status) for c in cells] == [
        ("olmo-1b", "decode_32k", "ok"), ("olmo-1b", "long_500k", "skipped")]
    ok = cells[0]
    peaks = R.peaks_for("NVIDIA H100 80GB HBM3")
    assert ok.compute_s == rec["flops_corrected"] / peaks.bf16_flops
    assert ok.memory_s == rec["hbm_bytes_corrected"] / peaks.hbm_bytes_per_s
    assert ok.collective_s == 0 and ok.dominant == "memory"
    assert "olmo-1b" in R.format_table(cells)


def test_roofline_terms_match_the_reference():
    for args in ((197e12, 819e9, 0.0, 1), (1e15, 3e12, 5e10, 4),
                 (2.5e16, 1e13, 7e11, 256)):
        for peaks in ((197e12, 819e9, 50e9), (989e12, 3.35e12, 450e9)):
            got = M.roofline(*args, peak_flops=peaks[0], hbm_gbs=peaks[1],
                             link_gbs=peaks[2])
            want = RM.roofline(*args, *peaks)
            assert (got.compute_s, got.memory_s, got.collective_s,
                    got.dominant, got.seconds) == \
                (want.compute_s, want.memory_s, want.collective_s,
                 want.dominant, want.seconds)
    t = M.RooflineTerms(compute_s=3.0, memory_s=1.0, collective_s=2.0)
    assert t.dominant == "compute" and t.seconds == 3.0
    with pytest.raises(TypeError):
        M.roofline(1.0, 1.0, 1.0, 1)          # no default peaks


def test_model_flops_match_the_reference():
    for arch in C.ARCH_IDS:
        for shape in SHAPES:
            assert R.model_flops(C.get(arch), shape) == \
                RR.model_flops(RC.get(arch), shape)


def test_peaks_table():
    sxm = R.peaks_for("H100 80GB HBM3")
    assert sxm is R.peaks_for("NVIDIA H100 80GB HBM3")
    assert (sxm.bf16_flops, sxm.tf32_flops, sxm.hbm_bytes_per_s) == \
        (989e12, 495e12, 3.35e12)
    assert R.peaks_for("NVIDIA H100 PCIe").hbm_bytes_per_s == 2.0e12
    with pytest.raises(KeyError, match="no peaks"):
        R.peaks_for("TPU v5e")


# ---------------------------------------------------------------------- #
# collectives
# ---------------------------------------------------------------------- #
HLO = """
  %ar = f32[1024,256]{1,0} all-reduce(f32[1024,256]{1,0} %x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = bf16[64,128]{1,0} all-gather(bf16[16,128]{1,0} %y), replica_groups=[2,4]<=[8], dimensions={0}
  %rs = f32[256]{0} reduce-scatter(f32[1024]{0} %z), replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add
  %rs2 = bf16[8,64]{1,0} reduce-scatter(bf16[128,64]{1,0} %z2), replica_groups=[1,16]<=[16], dimensions={0}
  %a2a = f32[8,32]{1,0} all-to-all(f32[8,32]{1,0} %w), replica_groups={{0,1}}, dimensions={0}
  %cp = s32[100]{0} collective-permute(s32[100]{0} %v), source_target_pairs={{0,1},{1,0}}
  %ars = (f32[1024]{0}, f32[1024]{0}) all-reduce-start(f32[1024]{0} %x), replica_groups={{0,1}}
  %ags = (bf16[16,128]{1,0}, bf16[64,128]{1,0}) all-gather-start(bf16[16,128]{1,0} %y), replica_groups=[2,4]<=[8]
  %cps = (f32[8]{0}, f32[8]{0}, u32[], u32[]) collective-permute-start(f32[8]{0} %u), source_target_pairs={{0,1}}
  %add = f32[] add(f32[] %a, f32[] %b)
"""


def test_collectives_match_the_reference():
    want = RH.parse_collectives(HLO)
    got = CA.CollectiveStats()
    for line in HLO.splitlines():
        m = RH._INSTR_RE.search(line)
        if m:
            op = m.group(2)
            got.add(op.replace("-start", ""), CA.wire_bytes(
                op, RH._shape_bytes(m.group(1)), RH._group_size(line)))
    assert got.ops == want.ops and set(want.ops) == set(RH._COLLECTIVES)
    assert got.bytes_by_op == want.bytes_by_op
    assert got.total_wire_bytes == want.total_wire_bytes
    with pytest.raises(ValueError):
        CA.wire_bytes("add", 4.0)


def test_argument_bytes():
    cfg = C.get_smoke("olmo-1b")
    specs = ST.input_specs(cfg, ShapeSpec("t", 64, 2, "train"))
    params = sum(p.numel() * p.element_size()
                 for p in specs["params"].parameters())
    assert CA.argument_bytes(specs["params"]) == params
    n = sum(p.numel() for p in specs["params"].parameters())
    # AdamW: fp32 m, v and master, an int32 step
    assert CA.argument_bytes(specs["opt_state"]) == 12 * n + 4
    assert CA.argument_bytes(specs["batch"]) == 2 * 2 * 64 * 4


# ---------------------------------------------------------------------- #
# the kernels' meta routes
# ---------------------------------------------------------------------- #
class _Tally:
    def __init__(self):
        self.calls = []

    def add_kernel(self, kernel, flops, nbytes):
        self.calls.append((kernel, flops, nbytes))


def test_meta_routes_return_shapes_and_report_counts():
    m = torch.device("meta")
    before = [k.launches for k in MODEL_KERNELS] + \
        [block_sparse_matmul.launches]
    tally = _Tally()
    q = torch.empty(2, 8, 100, 64, dtype=torch.bfloat16, device=m)
    k = torch.empty(2, 2, 120, 64, dtype=torch.bfloat16, device=m)
    x = torch.empty(2, 3, 16, 4, 32, device=m)
    a = torch.empty(2, 4, 3, 16, device=m)
    bc = torch.empty(2, 3, 16, 8, device=m)
    tiles = torch.empty(5, 64, 32, device=m)
    idx = torch.empty(5, dtype=torch.int64, device=m)
    bmat = torch.empty(96, 40, dtype=torch.bfloat16, device=m)
    with kmeta.counting(tally):
        o = flash_attention(q, k, k, causal=False)
        lse = torch.empty(2, 8, 100, device=m)
        dq, dk, dv = flash_attention_bwd(q, k, k, o, lse, o, causal=False)
        y = ssd_chunk(x, a, bc, bc)
        grads = ssd_chunk_bwd(x, a, bc, bc, torch.empty(x.shape, device=m))
        z = block_sparse_matmul(tiles, idx, idx, bmat, m=130)
    assert (o.shape, o.dtype, o.device) == (q.shape, q.dtype, m)
    assert [t.shape for t in (dq, dk, dv)] == [q.shape, k.shape, k.shape]
    assert (y.shape, y.dtype) == (x.shape, torch.float32)
    assert [g.shape for g in grads] == [x.shape, a.shape, bc.shape, bc.shape]
    assert (z.shape, z.dtype) == ((130, 40), torch.float32)
    fshape, sshape = (2, 8, 2, 100, 120, 64), (2, 3, 16, 4, 32, 8)
    bsmm = sys.modules["repro_torch.kernels.block_sparse_matmul"]
    assert tally.calls == [
        ("flash_attention", FA.flops(fshape, False),
         FA.nbytes(fshape, torch.bfloat16)),
        ("flash_attention_bwd", FB.flops(fshape, False),
         FB.nbytes(fshape, torch.bfloat16)),
        ("ssd_chunk", SC.flops(sshape), SC.nbytes(sshape, torch.float32)),
        ("ssd_chunk_bwd", SB.flops(sshape), SB.nbytes(sshape,
                                                      torch.float32)),
        ("block_sparse_matmul", bsmm.flops(5, 64, 32, 40),
         bsmm.nbytes(5, 64, 32, 96, 40, 130, torch.float32,
                     torch.bfloat16))]
    assert [k.launches for k in MODEL_KERNELS] + \
        [block_sparse_matmul.launches] == before
    # outside its domain a meta call raises, as a launch does
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(torch.empty(1, 1, 4, 48, device=m),
                        torch.empty(1, 1, 4, 48, device=m),
                        torch.empty(1, 1, 4, 48, device=m))
    # the CPU route is the plain version, untouched by a counter
    with kmeta.counting(tally):
        flash_attention(torch.zeros(1, 1, 4, 32), torch.zeros(1, 1, 4, 32),
                        torch.zeros(1, 1, 4, 32))
    assert len(tally.calls) == 5


# ---------------------------------------------------------------------- #
# chip_smoke.py's bounds from the kernels' own counts
# ---------------------------------------------------------------------- #
@pytest.fixture
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as mod
        yield mod
    finally:
        sys.path.remove(str(ROOT))


def test_chip_smoke_bounds_at_the_kernel_table_shapes(chip_smoke):
    """The bounds of ``PERF.md`` §6's kernel table, to its digits: flash
    at Qwen2-7B's prefill (bf16 0.1217 ms), ``ssd_chunk`` at Mamba2's
    (0.0620), its backward at Mamba2's train shape (0.1678 / 0.2529),
    block-sparse at the bench's 1,211 tiles (0.2463 / 0.0411), the
    merges' bytes bounds (0.00114 / 0.00165), each from the kernel
    module's ``flops`` and ``nbytes``."""
    cs = chip_smoke
    fa = (4, 28, 4, 2048, 2048, 128)
    assert round(cs.flash_bound(fa, torch.bfloat16)[0], 4) == 0.1217
    assert round(cs.flash_bound(fa, torch.float32)[0], 4) == 0.7292
    assert round(cs.ssd_bound((4, 8, 256, 64, 64, 128),
                              torch.bfloat16)[0], 4) == 0.0620
    tr = (8, 8, 256, 64, 64, 128)
    assert round(cs.ssd_bwd_bound(tr, torch.bfloat16)[0], 4) == 0.1678
    assert round(cs.ssd_bwd_bound(tr, torch.float32)[0], 4) == 0.2529
    olmo = (8, 16, 16, 2048, 2048, 128)
    assert round(cs.flash_bwd_bound(olmo, torch.bfloat16)[0], 4) == 0.3476
    assert round(cs.bsmm_bound(1211, 128, 128, 8192, 1024, 8192,
                               torch.float32)[0], 4) == 0.2463
    assert round(cs.bsmm_bound(1211, 128, 128, 8192, 1024, 8192,
                               torch.bfloat16)[0], 4) == 0.0411
    assert round(cs.merge_bound_ms("merge_path", (112500, 112500)),
                 5) == 0.00114
    assert round(cs.merge_bound_ms("multi_merge_ranks", (115000,) * 3),
                 5) == 0.00165
    # one source: the script's counts are the modules'
    assert cs.flash_flops(fa) == FA.flops(fa)
    assert cs.ssd_bwd_flops(tr) == SB.flops_by_product(tr)
    assert cs.HBM_BYTES_PER_S == R.peaks_for(cs.BOUND_CARD).hbm_bytes_per_s
