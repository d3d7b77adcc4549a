"""The port's sharding layer and meshes against the reference, on the CPU.

Every spec function (``spec_for``, ``param_pspec``, ``_dims_spec``,
``param_pspecs`` with FSDP on and off, ``batch_pspecs``,
``cache_pspecs``, ``token_pspec``, ``compile_mapping``,
``mapping_spec_for_step``, ``step_partition_specs``) is held to the
reference's, ``tuple(port) == tuple(ref)``, on the abstract meshes 1 x 1,
2 x 2, 4 x 4, 16 x 16 and 2 x 16 x 16 (jax's current
``AbstractMesh(axis_sizes, axis_names)``), for every arch at full width
and every ``SHAPES`` cell.  The reference's parameters are taken in its
unscanned layout (``scan_layers=False``), whose shapes are the port's,
and matched to the port's names through ``carry._reference_flat``.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.configs.base import SHAPES as RSHAPES
from repro.launch import sharding as RS
from repro.launch.mesh import mesh_axis_sizes as r_mesh_axis_sizes
from repro.launch.mesh import n_chips as r_n_chips
from repro.models import api as rapi
from repro.optim import optimizers as RO
from repro.sharding import compiler as RCOMP
from repro.sharding import logical as RL

import repro_torch.configs as C
from repro_torch.carry import _reference_flat
from repro_torch.configs.base import SHAPES
from repro_torch.launch import sharding as S
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import (Mesh, make_mesh, make_production_mesh,
                                     mesh_axis_sizes, n_chips)
from repro_torch.optim import optimizers as TO
from repro_torch.sharding import compiler as COMP
from repro_torch.sharding import logical as L

#: (axis sizes, axis names) of the abstract meshes the specs are held on
MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((4, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, m[0])) for m in MESHES]


def _meshes(sizes, names):
    return Mesh(names, sizes), jax.sharding.AbstractMesh(sizes, names)


def _t(spec):
    return tuple(spec)


def _flat_port(tree, prefix=""):
    """A nested name -> spec dict flattened to dotted names."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_port(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = _t(v)
    return out


@functools.lru_cache(maxsize=None)
def _ref_cfg(arch):
    return dataclasses.replace(RC.get(arch), scan_layers=False)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(lambda: rapi.init(_ref_cfg(arch),
                                            jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return ST.param_specs(C.get(arch))


# ---------------------------------------------------------------------- #
# spec_for, param_pspec, _dims_spec
# ---------------------------------------------------------------------- #
LOGICAL = [((8, 6), ("batch", "heads")), ((64, 4096, 32), ("batch", "seq",
                                                            "heads")),
           ((32, 512, 8, 128), ("batch", "kv_seq", "kv_heads", None)),
           ((256, 1024), ("experts", "ff")), ((3, 4096), ("batch", "vocab")),
           ((128, 96, 16), ("expert_group", "expert_cap", "embed")),
           ((1, 524288, 8), ("batch", "kv_seq", "state")), ((), ())]
RULES = {"default": (L.default_rules, RL.default_rules),
         "train": (S.train_rules, RS.train_rules),
         "decode": (S.decode_rules, RS.decode_rules)}


@pytest.mark.parametrize("sizes,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("rules", list(RULES))
def test_spec_for_and_dims_spec_match_reference(sizes, names, rules):
    port_mesh, ref_mesh = _meshes(sizes, names)
    port_rules, ref_rules = (f() for f in RULES[rules])
    L.set_rules(port_rules)
    RL.set_rules(ref_rules)
    try:
        for shape, logical in LOGICAL:
            assert _t(L.spec_for(shape, logical, port_mesh)) == \
                _t(RL.spec_for(shape, logical, mesh=ref_mesh))
            assert _t(S._dims_spec(shape, logical, port_mesh, port_rules)) \
                == _t(RS._dims_spec(shape, logical, ref_mesh, ref_rules))
        # no mesh: replicated
        assert _t(L.spec_for((8, 6), ("batch", "heads"))) == (None, None)
    finally:
        L.set_rules(None)
        RL.set_rules(None)


SHAPES_PSPEC = [(512, 1024), (512, 1000), (48, 512, 1024), (7, 5), (4096,),
                (64, 6144, 8), (48, 4, 4352), (8, 2048, 32768), (1, 16),
                (16, 16, 16), ()]


@pytest.mark.parametrize("tp,dp", [(1, 1), (2, 2), (4, 4), (16, 16),
                                   (16, 8), (8, 16)])
def test_param_pspec_matches_reference(tp, dp):
    for shape in SHAPES_PSPEC:
        for skip in (True, False):
            assert _t(S.param_pspec(shape, tp, dp, skip)) == \
                _t(RS.param_pspec(shape, tp, dp, skip))


# ---------------------------------------------------------------------- #
# param_pspecs on every arch at full width, params and optimizer state
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("sizes,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_param_pspecs_match_reference(arch, sizes, names):
    port_mesh, ref_mesh = _meshes(sizes, names)
    cfg = _ref_cfg(arch)
    for fsdp in (True, False):
        want = {k: _t(v) for k, v in _reference_flat(
            RS.param_pspecs(_ref_params(arch), ref_mesh, fsdp), cfg).items()}
        got = _flat_port(S.param_pspecs(_port_params(arch), port_mesh, fsdp))
        assert got == want


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-moe-a2.7b",
                                  "grok-1-314b", "mamba2-1.3b"])
def test_opt_state_pspecs_match_reference(arch):
    """AdamW's and (grok-1) Adafactor's state inherit the parameters'
    specs, each moment under its parameter's name."""
    port_mesh, ref_mesh = _meshes((16, 16), ("data", "model"))
    cfg = _ref_cfg(arch)
    ref_state = jax.eval_shape(RO.for_config(cfg).init, _ref_params(arch))
    port_state = ST.opt_state_specs(C.get(arch), TO.for_config(C.get(arch)),
                                    _port_params(arch))
    got = S.param_pspecs(port_state, port_mesh)
    ref = RS.param_pspecs(ref_state, ref_mesh)
    assert _t(got["step"]) == _t(ref["step"])
    for key in ref:
        if key == "step":
            continue
        want = {k: _t(v) for k, v in _reference_flat(ref[key], cfg).items()}
        assert _flat_port(got[key]) == want


def test_param_pspecs_scan_layout_differs_as_documented():
    """In the reference's scanned layout its FSDP rule shards the stacked
    layer dim of two tensors (``launch/sharding.py``'s docstring); the
    port, one tensor a layer, gives the unscanned layout's specs."""
    mesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    for arch, leaf, want in (("grok-1-314b", ("moe", "router"),
                              ("data", "model", None)),
                             ("mamba2-1.3b", ("mamba", "conv_w"),
                              ("data", None, "model"))):
        scanned = jax.eval_shape(lambda: rapi.init(RC.get(arch),
                                                   jax.random.PRNGKey(0)))
        spec = RS.param_pspecs(scanned, mesh)["blocks"]
        for k in leaf:
            spec = spec[k]
        assert _t(spec) == want
        port = S.param_pspecs(_port_params(arch), Mesh(("data", "model"),
                                                       (16, 16)))
        name = "blocks.0." + ".".join(leaf)
        assert len(port[name]) == len(want) - 1


# ---------------------------------------------------------------------- #
# batch, cache and token specs on every arch and cell
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("sizes,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_batch_cache_token_pspecs_match_reference(arch, sizes, names):
    port_mesh, ref_mesh = _meshes(sizes, names)
    cfg, rcfg = C.get(arch), _ref_cfg(arch)
    for name, shape in SHAPES.items():
        rshape = RSHAPES[name]
        got = {k: _t(v) for k, v in S.batch_pspecs(cfg, shape,
                                                    port_mesh).items()}
        assert got == {k: _t(v) for k, v in RS.batch_pspecs(
            rcfg, rshape, ref_mesh).items()}
        b, s = shape.global_batch, shape.seq_len
        got = {k: _t(v) for k, v in S.cache_pspecs(cfg, b, s,
                                                   port_mesh).items()}
        assert got == {k: _t(v) for k, v in RS.cache_pspecs(
            rcfg, b, s, ref_mesh).items()}
        assert _t(S.token_pspec(b, port_mesh)) == \
            _t(RS.token_pspec(b, ref_mesh))


# ---------------------------------------------------------------------- #
# the TeAAL mapping compiler
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dp,tp,pods", [(1, 1, 1), (2, 2, 1), (4, 4, 1),
                                        (16, 16, 1), (16, 16, 2)])
def test_mapping_compiler_matches_reference(dp, tp, pods):
    spec, rspec = COMP.mapping_spec_for_step(dp, tp, pods), \
        RCOMP.mapping_spec_for_step(dp, tp, pods)
    assert spec.einsum.declaration == rspec.einsum.declaration
    assert spec.mapping.rank_order == rspec.mapping.rank_order
    binding = {"B1": ("pod", "data") if pods > 1 else "data", "F1": "model"}
    for params in ({"B0S": 2, "F0S": 8}, {"B0S": 1, "F0S": 1}):
        for out in ("H", "Y"):
            got = COMP.compile_mapping(spec, out, binding, params)
            want = RCOMP.compile_mapping(rspec, out, binding, params)
            assert {k: _t(v) for k, v in got.items()} == \
                {k: _t(v) for k, v in want.items()}
    for arch in C.ARCH_IDS:
        cfg = C.get(arch)
        for shape in SHAPES.values():
            got = COMP.step_partition_specs(shape.global_batch, cfg.d_model,
                                            cfg.d_ff, dp, tp, pods)
            want = RCOMP.step_partition_specs(shape.global_batch,
                                              cfg.d_model, cfg.d_ff, dp, tp,
                                              pods)
            assert {k: _t(v) for k, v in got.items()} == \
                {k: _t(v) for k, v in want.items()}


def test_compile_mapping_unbound_spatial_rank_raises_as_reference():
    for mod in (COMP, RCOMP):
        spec = mod.mapping_spec_for_step(dp=4, tp=4)
        with pytest.raises(ValueError, match="B1|F1"):
            mod.compile_mapping(spec, "H", {"B1": "data"},
                                params={"B0S": 2, "F0S": 8})


# ---------------------------------------------------------------------- #
# the port's versions of the reference cases that fail on its old
# AbstractMesh signature (tests/test_sharding.py)
# ---------------------------------------------------------------------- #
def test_embedding_path_aware():
    mesh = Mesh(("data", "model"), (4, 4))
    params = {"embed.tok": torch.zeros((1024, 64), device="meta"),
              "blocks.w": torch.zeros((64, 256), device="meta")}
    specs = S.param_pspecs(params, mesh)
    # vocab dim sharded over model (so tied-lm-head logits shard)
    assert specs["embed.tok"] == L.PartitionSpec("model", "data")
    ref = RS.param_pspecs({"embed": {"tok": jax.ShapeDtypeStruct(
        (1024, 64), np.float32)}, "blocks": {"w": jax.ShapeDtypeStruct(
            (64, 256), np.float32)}}, jax.sharding.AbstractMesh(
                (4, 4), ("data", "model")))
    assert _t(specs["embed.tok"]) == _t(ref["embed"]["tok"])
    assert _t(specs["blocks.w"]) == _t(ref["blocks"]["w"])


def test_divisibility_fallback_in_rules():
    mesh = Mesh(("data", "model"), (4, 4))
    L.set_rules(L.AxisRules({"batch": ("data",), "heads": ("model",)}))
    try:
        # 6 heads % 4 != 0 -> replicated, batch 8 % 4 == 0 -> sharded
        assert L.spec_for((8, 6), ("batch", "heads"), mesh=mesh) == \
            L.PartitionSpec("data", None)
    finally:
        L.set_rules(None)


def test_cache_pspecs_shard_kv_seq():
    mesh = Mesh(("data", "model"), (2, 2))
    specs = S.cache_pspecs(C.get_smoke("qwen3-14b"), batch=4, max_len=64,
                           mesh=mesh)
    # [L, b, s, kv, h]: batch over pod(data), seq over (data, model)
    assert specs["k"][1] is not None or specs["k"][2] is not None


def test_train_step_specs_on_a_4x2_mesh_and_the_one_device_run():
    """The reference's multi-device case lowers a smoke OLMo train step on
    a 4 x 2 mesh.  The port computes the same specs for that mesh, cannot
    place a step on it (no multi-device execution), and runs the step on
    a 1 x 1 CPU mesh with every input placed."""
    cfg = C.get_smoke("olmo-1b")
    rcfg = dataclasses.replace(RC.get_smoke("olmo-1b"), scan_layers=False)
    shape, rshape = (type(s)("t", 64, 8, "train") for s in
                     (SHAPES["train_4k"], RSHAPES["train_4k"]))
    port_mesh, ref_mesh = _meshes((4, 2), ("data", "model"))
    params = ST.param_specs(cfg)
    rparams = jax.eval_shape(lambda: rapi.init(rcfg, jax.random.PRNGKey(0)))
    assert _flat_port(S.param_pspecs(params, port_mesh)) == {
        k: _t(v) for k, v in _reference_flat(
            RS.param_pspecs(rparams, ref_mesh), rcfg).items()}
    assert {k: _t(v) for k, v in S.batch_pspecs(cfg, shape,
                                                port_mesh).items()} == \
        {k: _t(v) for k, v in RS.batch_pspecs(rcfg, rshape,
                                              ref_mesh).items()}
    with pytest.raises(ValueError, match="8 devices; 1 cpu"):
        make_mesh(4, 2, device="cpu")
    with pytest.raises(ValueError, match="abstract"):
        S.NamedSharding(port_mesh, L.PartitionSpec()).place(torch.zeros(1))
    two = Mesh(("data", "model"), (2, 1), (torch.device("cpu"),) * 2)
    with pytest.raises(NotImplementedError, match="2 devices"):
        S.NamedSharding(two, L.PartitionSpec()).place(torch.zeros(1))
    mesh = make_mesh(1, 1, device="cpu")
    model = ST.param_specs(cfg).to_empty(device="cpu")
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02)
    opt = TO.for_config(cfg)
    state = opt.init(dict(model.named_parameters()))
    S.place(model, S.param_shardings(model, mesh))
    state = S.place(state, S.param_shardings(state, mesh))
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=gen),
             "labels": torch.randint(0, cfg.vocab, (2, 32), generator=gen)}
    L.set_mesh(mesh)
    L.set_rules(S.rules_for("train"))
    try:
        _, _, m = ST.make_train_step(cfg, opt, device="cpu")(model, state,
                                                              batch)
    finally:
        L.set_mesh(None)
        L.set_rules(None)
    assert np.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------- #
# meshes, constrain, placement
# ---------------------------------------------------------------------- #
def test_meshes():
    mesh = make_mesh(1, 1, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.devices == (torch.device("cpu"),) and not mesh.abstract
    assert n_chips(mesh) == 1
    assert make_mesh(1, 1, pods=1, device="meta").devices == \
        (torch.device("meta"),)
    with pytest.raises(ValueError, match="2 devices; 1 cpu"):
        make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="4 devices; 1 cpu"):
        make_mesh(1, 2, pods=2, device="cpu")
    for multi in (False, True):
        port = make_production_mesh(multi_pod=multi)
        sizes = (2, 16, 16) if multi else (16, 16)
        names = ("pod", "data", "model") if multi else ("data", "model")
        ref = jax.sharding.AbstractMesh(sizes, names)
        assert port.abstract and port.axis_names == names
        assert mesh_axis_sizes(port) == r_mesh_axis_sizes(ref)
        assert n_chips(port) == r_n_chips(ref) == (512 if multi else 256)


def test_make_mesh_wants_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(1, 1)


def test_constrain_is_the_identity_on_one_device_and_raises_on_more():
    x = torch.zeros(4, 6)
    assert L.constrain(x, ("batch", "heads")) is x          # no mesh
    L.set_mesh(make_mesh(1, 1, device="cpu"))
    try:
        assert L.constrain(x, ("batch", "heads")) is x
        with pytest.raises(ValueError):
            L.constrain(x, ("batch",))
        L.set_mesh(Mesh(("data", "model"), (2, 2)))
        with pytest.raises(NotImplementedError, match="4 devices"):
            L.constrain(x, ("batch", "heads"))
    finally:
        L.set_mesh(None)


def test_param_shardings_place_each_tensor_whole_on_the_one_device():
    cfg = C.get_smoke("qwen2-moe-a2.7b")
    model = ST.param_specs(cfg)
    mesh = make_mesh(1, 1, device="cpu")
    shardings = S.param_shardings(model, mesh)
    assert set(shardings) == {n for n, _ in model.named_parameters()}
    for sh in shardings.values():
        assert sh.mesh is mesh and all(a is None for a in sh.spec)
    model = model.to_empty(device="cpu")
    before = {n: p.data_ptr() for n, p in model.named_parameters()}
    S.place(model, shardings)
    assert {n: p.data_ptr() for n, p in model.named_parameters()} == before
    with pytest.raises(ValueError, match="abstract"):
        S.NamedSharding(make_production_mesh(), L.PartitionSpec()).place(
            torch.zeros(1))


def test_train_launcher_runs_through_the_mesh(tmp_path):
    """``launch/train.py --dp 1 --tp 1`` trains on a 1 x 1 mesh over the
    device; ``--dp 2`` on one device raises from ``make_mesh``."""
    from repro_torch.launch import train
    args = ["--smoke", "--arch", "olmo-1b", "--steps", "2", "--seq", "32",
            "--batch", "2", "--device", "cpu", "--log-every", "1", "--ckpt-dir",
            str(tmp_path / "ckpt")]
    trainer = train.main(args + ["--dp", "1", "--tp", "1"])
    assert trainer.mesh.shape == {"data": 1, "model": 1}
    assert trainer.mesh.devices == (torch.device("cpu"),)
    assert len(trainer.metrics_log) == 2
    with pytest.raises(ValueError, match="2 devices; 1 cpu"):
        train.main(args + ["--dp", "2"])
    with pytest.raises(ValueError, match="a device or a mesh"):
        type(trainer)(trainer.cfg, trainer.tcfg, device="cpu",
                      mesh=trainer.mesh)


def test_trainer_on_a_one_device_mesh_is_the_loop_without_one(tmp_path):
    """The ``Trainer`` on ``make_mesh(1, 1)`` gives, bit for bit, the
    losses of the train step run by hand over the same seeded weights,
    optimizer and batches, as the loop ran before it took a mesh."""
    from repro_torch.models import api
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = C.get_smoke("olmo-1b")
    tcfg = TrainerConfig(total_steps=3, checkpoint_every=10, log_every=1,
                         global_batch=2, seq_len=32,
                         checkpoint_dir=str(tmp_path / "ckpt"))
    trainer = Trainer(cfg, tcfg, mesh=make_mesh(1, 1, device="cpu"))
    trainer.train()
    got = [r["loss"] for r in trainer.metrics_log]
    model = api.init(cfg, torch.Generator("cpu").manual_seed(0), "cpu")
    opt = TO.for_config(cfg)
    state = opt.init(dict(model.named_parameters()))
    step = ST.make_train_step(cfg, opt, device="cpu")
    want = []
    for i in range(3):
        model, state, m = step(model, state,
                               trainer.data.global_batch_at(i))
        want.append(float(m["loss"]))
    assert got == want
    assert L.current_mesh() is None          # the loop leaves no mesh set
