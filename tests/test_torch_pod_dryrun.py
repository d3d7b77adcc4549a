"""The dry run walked over meshes of many devices (``launch/mesh.
walked_mesh``: DTensor on torch's ``fake`` process group, on ``meta``),
on the CPU, at smoke widths on 4 to 8 fake ranks:

  * per-device FLOPs at 2 x 4 against the reference's XLA count of the
    same cells (compiled in a child process that forces 8 host devices,
    on an Auto-axis mesh), and the collectives' wire bytes beside
    XLA's, both held at the ratios stated;
  * one dense layer's collectives at 2 x 2 against a count by hand from
    the parameter specs: FSDP all-gathers, the TP all-reduces after
    ``wo`` and ``w_out``, the gradients' reduce-scatters;
  * for each family, per-device FLOPs x chips against the one-device
    walk;
  * ``constrain`` and the placements of a spec; the process group left
    by ``run_cell`` (none, also after an error) and ``host_shard``
    during a walk; ``--mesh both`` through the CLI; the roofline's
    collective term on the network between nodes.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import repro_torch.configs as C
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch import sharding as S
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import (Mesh, host_shard, make_mesh,
                                     walked_mesh)
from repro_torch.sharding import logical as L

ROOT = Path(__file__).resolve().parents[1]
CHILD_THREADS = {"OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}
#: one smoke config a family
FAMILIES = {"dense": "qwen2-7b", "vlm": "llava-next-34b",
            "moe": "qwen2-moe-a2.7b", "ssm": "mamba2-1.3b",
            "hybrid": "jamba-1.5-large-398b", "encdec": "whisper-small"}

# ---------------------------------------------------------------------- #
# per-device FLOPs at 2 x 4 against XLA's
# ---------------------------------------------------------------------- #
#: the reference's dry-run lowering of four smoke cells at batch 4 x 64
#: on a 2 x 4 Auto-axis mesh of forced host devices, with its logical
#: mesh and rules set as its ``run_cell`` sets them: per-device
#: cost_analysis FLOPs and parsed collective wire bytes
_XLA = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
import repro.configs as RC
from repro.configs.base import SHAPES
from repro.launch import dryrun as RD, sharding as RS
from repro.sharding import logical as RL
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for cell in sys.argv[1:]:
    arch, kind = cell.split("/")
    shape = SHAPES["train_4k"].__class__("t", 64, 4, kind)
    RL.set_mesh(mesh)
    RL.set_rules(RS.rules_for(kind))
    try:
        _, compiled = RD._lower_compile(RC.get_smoke(arch), shape, mesh)
    finally:
        RL.set_mesh(None)
        RL.set_rules(None)
    c = RD._cell_costs(compiled)
    out[cell] = {"flops": c["flops"], "wire": c["collective_wire_bytes"]}
print(json.dumps(out))
"""

#: (arch, kind, the port's per-device FLOPs over XLA's, its wire bytes
#: over XLA's), measured here.  The port's count x 8 equals its 1 x 1
#: count exactly (the next test); XLA's x 8 exceeds its own 1 x 1 count
#: by 5 to 15 % (elementwise work it repeats on every ``model`` device),
#: so the ratios sit below the 1 x 1 ones of test_torch_dryrun.py
#: (0.92 and 0.86-0.87), the OLMo train step below the 0.85 that was
#: predicted.  The wire bytes are DTensor's choice of collectives, not
#: XLA's: fewer all-to-alls, the gradients reduced once.
XLA_CELLS = [("olmo-1b", "prefill", 0.8664, 0.4413),
             ("olmo-1b", "train", 0.7668, 0.3731),
             ("qwen2-7b", "prefill", 0.8618, 0.3632),
             ("qwen2-7b", "train", 0.8328, 0.3232)]


@pytest.fixture(scope="module", autouse=True)
def xla_child():
    """The reference's compiles, started with the module's first test so
    that they run beside the walks (their tests come last)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               **CHILD_THREADS)
    child = subprocess.Popen(
        [sys.executable, "-c", _XLA] + [f"{a}/{k}" for a, k, _, _ in
                                        XLA_CELLS],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield child
    child.kill()
    child.communicate()


@pytest.fixture(scope="module")
def xla_counts(xla_child):
    out, err = xla_child.communicate(timeout=300)
    assert xla_child.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def _walk(cfg, shape, sizes):
    with walked_mesh(sizes) as mesh:
        return D.walk(cfg, shape, mesh)


# ---------------------------------------------------------------------- #
# one dense layer's collectives by hand
# ---------------------------------------------------------------------- #
def _collectives(cfg, shape, sizes):
    cost = _walk(cfg, shape, sizes)
    return cost.collectives.ops, cost.collectives.bytes_by_op


def test_one_dense_layer_collectives_equal_the_count_by_hand():
    """OLMo's smoke layer (no norm weights) at 2 x 2, 4 x 64: the 2-layer
    walk less the 1-layer walk, the slope the probes extrapolate.  Each
    of its 7 weights is FSDP-sharded over ``data`` and TP-split over
    ``model`` (``param_pspecs``).  A train step all-gathers each over
    ``data`` for the forward, again for the backward, and the 6 that
    remat recomputes (all but ``w_out``, whose output the backward does
    not read) once more; all-reduces the row-parallel partial sums
    after ``wo`` and ``w_out`` (``wo`` again in the recomputation) and
    the column-parallel input gradients of the attention and the FFN;
    and reduce-scatters each weight's gradient once over ``data``."""
    import dataclasses
    cfg = C.get_smoke("olmo-1b")
    assert cfg.nonparam_ln and cfg.act == "swiglu"
    shape = ShapeSpec("t", 64, 4, "train")
    ops1, bytes1 = _collectives(dataclasses.replace(cfg, n_layers=1),
                                shape, (2, 2))
    ops2, bytes2 = _collectives(dataclasses.replace(cfg, n_layers=2),
                                shape, (2, 2))
    got_ops = {k: ops2.get(k, 0) - ops1.get(k, 0) for k in ops2}
    got_bytes = {k: bytes2.get(k, 0) - bytes1.get(k, 0) for k in bytes2}

    layer = ST.param_specs(dataclasses.replace(cfg, n_layers=1)).blocks[0]
    specs = S.param_pspecs(layer, Mesh(("data", "model"), (2, 2)))
    weights = {k.split(".")[-1]: p for k, p in layer.named_parameters()}
    assert set(weights) == {"wq", "wk", "wv", "wo", "w_in", "w_gate",
                            "w_out"}
    assert all(set(spec) == {"data", "model"} for spec in specs.values())

    def local(name):           # one device's bytes of a weight: a quarter
        return weights[name].numel() * weights[name].element_size() // 4

    def gathered(name):        # its all-gather over data: the result
        return 2 * local(name)
    recomputed = ["wq", "wk", "wv", "wo", "w_in", "w_gate"]
    act = shape.global_batch // 2 * shape.seq_len * cfg.d_model * 2
    want_ops = {"all-gather": 7 + 6 + 7, "all-reduce": 2 + 1 + 2,
                "reduce-scatter": 7}
    want_bytes = {
        "all-gather": 2 * sum(map(gathered, weights))
        + sum(map(gathered, recomputed)),
        "all-reduce": 5 * 2 * act,
        # g x the result: the gradient's local shard, over 2 devices
        "reduce-scatter": sum(2 * local(w) for w in weights)}
    assert {k: v for k, v in got_ops.items() if v} == want_ops
    assert {k: v for k, v in got_bytes.items() if v} == want_bytes


# ---------------------------------------------------------------------- #
# per-device FLOPs x chips against one device
# ---------------------------------------------------------------------- #
#: per-device FLOPs x 8 over the 1 x 1 count at 2 x 4, train, one unit
#: (a layer, a superblock, an encoder and a decoder layer): at least 1,
#: and under 1.01.  Every product is sharded; what is left is the
#: products the SSD's chunk scan repeats on each ``model`` device
#: (Mamba2 1.0042, Jamba 1.0023 here).  On a mesh with ``pod`` the MoE
#: and hybrid steps exceed it: they split their dispatch groups over
#: ``data`` only (the reference's ``expert_group`` rule), so each pod
#: repeats the other's expert products (PERF.md).
FAMILY_BOUND = 1.01


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_per_device_flops_times_chips_against_one_device(fam):
    import dataclasses
    cfg = C.get_smoke(FAMILIES[fam])
    if fam == "encdec":
        cfg = dataclasses.replace(cfg, enc_layers=cfg.n_layers)
    cfg = D.probe_config(cfg, 1)
    shape = ShapeSpec("t", 64, 8, "train")
    one = D.walk(cfg, shape, make_mesh(1, 1, device="meta")).flops
    got = _walk(cfg, shape, (2, 4)).flops * 8 / one
    assert 1.0 <= got < FAMILY_BOUND


# ---------------------------------------------------------------------- #
# the flash kernel's count on a device when it splits the sequence
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("heads,rows", [(6, 4), (8, 1)])
def test_flash_count_is_the_busiest_devices(heads, rows):
    """At 2 x 4, 4 x 64 queries of ``heads`` heads of 64: 6 heads do not
    divide ``model``, so the queries' sequence is split into 4 blocks of
    16 rows and the device of the last block, rows 48..63, keeps the
    most causal pairs, sum(49..64) = 904 of 2,080 (1.74 x the mean
    520); 8 heads divide it, 2 a device, every row's pairs.  The count
    is that device's, forward and backward (5/2 of it), on its 2 rows
    of the batch."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
    from repro_torch.launch.cost_analysis import StepCost
    b, s, d = 4, 64, 64
    with walked_mesh((2, 4)) as mesh:
        L.set_mesh(mesh)
        L.set_rules(S.rules_for("train"))
        try:
            q, k, v, o, do = (
                L.constrain(torch.empty(b, heads, s, d, device="meta",
                                        dtype=torch.bfloat16),
                            ("batch", None, None, None)) for _ in range(5))
            lse = L.constrain(torch.empty(b, heads, s, device="meta"),
                              ("batch", None, None))
            with StepCost() as cost:
                flash_attention(q, k, v, causal=True)
                flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        finally:
            L.set_mesh(None)
            L.set_rules(None)
    first = s - s // rows
    pairs = sum(i + 1 for i in range(first, s))
    assert pairs == (904 if rows == 4 else 2080)
    fwd = 4 * (b // 2) * (heads * rows // 4) * d * pairs
    assert cost.kernel_flops["flash_attention"] == fwd
    assert cost.kernel_flops["flash_attention_bwd"] == fwd * 5 // 2


# ---------------------------------------------------------------------- #
# constrain, placements, the process group
# ---------------------------------------------------------------------- #
def test_constrain_on_a_one_by_one_mesh_returns_its_input():
    x = torch.zeros(4, 6, device="meta")
    L.set_mesh(make_mesh(1, 1, device="meta"))
    try:
        assert L.constrain(x, ("batch", "heads")) is x
    finally:
        L.set_mesh(None)


def test_placements_of_a_spec():
    mesh = Mesh(("pod", "data", "model"), (2, 16, 16))
    P = L.PartitionSpec
    assert L.placements(P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert L.placements(P(None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="against the mesh's order"):
        L.placements(P(("data", "pod")), mesh)


def test_constrain_redistributes_on_a_walked_mesh():
    with walked_mesh((2, 2)) as mesh:
        assert host_shard(list(range(6))) == list(range(6))
        L.set_mesh(mesh)
        L.set_rules(S.rules_for("train"))
        try:
            x = torch.empty(8, 4, 16, device="meta")
            y = L.constrain(x, ("batch", None, "ff"))
            assert tuple(y.placements) == (Shard(0), Shard(2))
            assert tuple(y.to_local().shape) == (4, 4, 8)
            assert L.constrain(y, ("batch", None, "ff")).placements == \
                y.placements
        finally:
            L.set_mesh(None)
            L.set_rules(None)
    assert not dist.is_initialized()


def test_no_process_group_left_after_run_cell(tmp_path, monkeypatch):
    rec = D.run_cell("mamba2-1.3b", "decode_32k", "pod_16x16",
                     card="H100 80GB HBM3", directory=tmp_path,
                     verbose=False)
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert not dist.is_initialized()
    assert host_shard(list(range(4))) == [0, 1, 2, 3]
    for key in ("flops", "hbm_bytes", "collective_wire_bytes",
                "collective_ops", "collective_bytes_by_op"):
        assert rec[key] == rec[key + "_corrected"]
    assert rec["argument_bytes"] > 0 and rec["fits"]

    def fails(*args, **kwargs):
        assert dist.is_initialized() and dist.get_world_size() == 512
        assert host_shard([0, 1]) == [0, 1]
        raise RuntimeError("planted")
    monkeypatch.setattr(D, "_walk_cell", fails)
    rec = D.run_cell("mamba2-1.3b", "decode_32k", "multipod_2x16x16",
                     card="H100 80GB HBM3", directory=tmp_path,
                     verbose=False)
    assert rec["status"] == "error" and "planted" in rec["error"]
    assert not dist.is_initialized()


def test_mesh_both_through_the_cli(tmp_path, capsys):
    D.main(["--arch", "mamba2-1.3b", "--shape", "decode_32k", "--mesh",
            "both", "--card", "H100 80GB HBM3", "--dir", str(tmp_path)])
    assert "ok=2 skipped=0 errors=0" in capsys.readouterr().out
    recs = {m: json.loads((tmp_path / f"mamba2-1.3b__decode_32k__{m}.json")
                          .read_text())
            for m in ("pod_16x16", "multipod_2x16x16")}
    assert {m: r["chips"] for m, r in recs.items()} == {
        "pod_16x16": 256, "multipod_2x16x16": 512}
    for r in recs.values():
        assert r["status"] == "ok" and r["collective_wire_bytes_corrected"] > 0
        assert sum(r["collective_ops_corrected"].values()) > 0
    cells = R.full_table("pod_16x16", tmp_path)
    assert [(c.arch, c.chips) for c in cells] == [("mamba2-1.3b", 256)]
    peaks = R.peaks_for("H100 80GB HBM3")
    rec = recs["pod_16x16"]
    assert cells[0].collective_s == \
        rec["collective_wire_bytes_corrected"] / R.NODE_LINK_BYTES_PER_S
    assert cells[0].compute_s == rec["flops_corrected"] / peaks.bf16_flops


def test_collective_term_crosses_nodes_above_eight_cards():
    peaks = R.peaks_for("H100 80GB HBM3")
    assert R.link_bytes_per_s(peaks, 1) == R.link_bytes_per_s(peaks, 8) == \
        peaks.link_bytes_per_s == 450e9
    assert R.link_bytes_per_s(peaks, 16) == \
        R.link_bytes_per_s(peaks, 512) == 50e9
    assert R.MESHES == ("h100_1x1", "pod_16x16", "multipod_2x16x16")


@pytest.mark.parametrize("arch,kind,flops_ratio,wire_ratio", XLA_CELLS)
def test_per_device_flops_at_2x4_against_xla(xla_counts, arch, kind,
                                             flops_ratio, wire_ratio):
    cost = _walk(C.get_smoke(arch), ShapeSpec("t", 64, 4, kind), (2, 4))
    xla = xla_counts[f"{arch}/{kind}"]
    got = cost.flops / xla["flops"]
    assert 0.75 <= got <= 1.0
    assert abs(got - flops_ratio) < 1e-3
    assert abs(cost.collectives.total_wire_bytes / xla["wire"]
               - wire_ratio) < 1e-3
