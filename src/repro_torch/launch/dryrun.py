"""Dry run: walk every (arch x shape) cell's step on the ``meta`` device
and count it (the reference's ``launch/dryrun.py``).

For each cell this module:
  1. builds the mesh: ``h100_1x1`` (one card), or the reference's
     ``pod_16x16`` (256 devices) and ``multipod_2x16x16`` (512), walked
     (``mesh.walked_mesh``: torch's ``fake`` process group of one rank a
     device, in this process, and a ``DeviceMesh`` over it),
  2. builds the step for the shape's kind (train with the config's
     optimizer, prefill or decode) and its input specs on ``meta``
     (``steps.input_specs``: nothing is allocated), placed by their
     shardings on that mesh (on a walked mesh each becomes a DTensor
     of its spec's placements),
  3. runs the step on them under ``cost_analysis.StepCost``: aten's
     products and bytes, each hand-written kernel's own count from its
     meta route, and on a walked mesh the collectives DTensor issues to
     keep the models' sharding constraints (``logical.constrain``), all
     counted on one device's shards; nothing is launched or computed,
  4. records the counts, the collectives by op, the argument bytes a
     device holds and whether they fit its card into
     experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.

A cell's full config costs two small walks: its 1- and 2-unit probes,
extrapolated to all its units (the ``*_corrected`` keys, as in the
reference, whose probes undo XLA counting a scanned layer once; the
port has no scan, and the probes only save time).  ``run_cell`` turns
on sequence parallelism for the wide dense prefills, as the
reference's does.  DTensor picks its own collectives where XLA's SPMD
partitioner picks others (XLA's all-to-alls, its fused reshards), so
the wire bytes differ from the reference's; ``PERF.md`` states the
ratio found.

Runs on the host; needs no card.  The peaks and the memory a card has
come from ``--card`` (``launch/roofline.PEAKS``), else from the CUDA
device's name and total memory.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k --card "H100 80GB HBM3"
  python -m repro_torch.launch.dryrun --all --mesh both --card "H100 80GB HBM3"
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

import repro_torch.configs as C
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.launch import sharding as S
from repro_torch.launch import steps
from repro_torch.launch.cost_analysis import StepCost, argument_bytes
from repro_torch.launch.mesh import Mesh, make_mesh, walked_mesh
from repro_torch.launch.roofline import peaks_for
from repro_torch.optim import optimizers as opt
from repro_torch.sharding import logical

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"
#: mesh name -> its axis sizes ((data, model) or (pod, data, model))
MESHES = {"h100_1x1": (1, 1), "pod_16x16": (16, 16),
          "multipod_2x16x16": (2, 16, 16)}
#: ``--mesh both``: the reference's two production meshes
BOTH = ("pod_16x16", "multipod_2x16x16")
#: the step's arguments by shape kind, in order
STEP_ARGS = {
    "train": ("params", "opt_state", "batch"),
    "prefill": ("params", "batch"),
    "decode": ("params", "cache", "token", "pos"),
}
#: the totals a probe pair extrapolates
TOTALS = ("flops", "hbm_bytes", "collective_wire_bytes")


def shardings_for(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
                  specs: Dict[str, Any]) -> Tuple:
    """The shardings of ``steps.input_specs``' arguments, in the step's
    order."""
    # decode serves from TP-sharded, data-replicated weights (no
    # optimizer to co-locate; FSDP would re-gather params every token)
    p_shard = S.named_shardings(S.param_pspecs(
        specs["params"], mesh, fsdp=shape.kind != "decode"), mesh)
    if shape.kind == "train":
        o_shard = S.param_shardings(specs["opt_state"], mesh)
        b_p = S.batch_pspecs(cfg, shape, mesh)
        b_shard = {k: S.NamedSharding(mesh, b_p[k]) for k in specs["batch"]}
        return (p_shard, o_shard, b_shard)
    if shape.kind == "prefill":
        b_p = S.batch_pspecs(cfg, shape, mesh)
        b_shard = {k: S.NamedSharding(mesh, b_p[k]) for k in specs["batch"]}
        return (p_shard, b_shard)
    c_p = S.cache_pspecs(cfg, shape.global_batch, shape.seq_len, mesh)
    c_shard = {k: S.NamedSharding(mesh, c_p[k]) for k in specs["cache"]}
    t_shard = S.NamedSharding(mesh, S.token_pspec(shape.global_batch, mesh))
    return (p_shard, c_shard, t_shard, t_shard)


def probe_config(cfg: ModelConfig, k: int) -> ModelConfig:
    """Same arch with k layer-units.  A 'unit' is a layer
    (dense/moe/ssm), a superblock (hybrid), or an encoder+decoder layer
    pair (encdec, whose enc_layers must equal n_layers: otherwise one
    unit count cannot stand for both stacks, and it raises)."""
    kw: Dict[str, Any] = {}
    if cfg.family == "hybrid":
        kw["n_layers"] = k * cfg.hybrid_block
    else:
        kw["n_layers"] = k
    if cfg.family == "encdec":
        if cfg.enc_layers != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {cfg.enc_layers} encoder and "
                             f"{cfg.n_layers} decoder layers; the probes "
                             f"take them in pairs")
        kw["enc_layers"] = k
    return dataclasses.replace(cfg, **kw)


def n_units(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_block
    return cfg.n_layers


def walk(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
         optimizer: Optional[opt.Optimizer] = None) -> StepCost:
    """The step of ``shape`` on ``cfg``'s meta inputs, placed on
    ``mesh``, run under a fresh counter (a train step with ``optimizer``,
    ``opt.for_config(cfg)`` by default), with ``mesh`` and the shape's
    rules as the models' logical mesh (``logical.set_mesh``)."""
    optimizer = optimizer or opt.for_config(cfg)
    specs = steps.input_specs(cfg, shape, optimizer)
    step = steps.step_for(cfg, shape, optimizer, device=steps.META)
    before = logical.current_mesh(), logical.current_rules()
    logical.set_mesh(mesh)
    logical.set_rules(S.rules_for(shape.kind))
    try:
        args = place_args(cfg, shape, mesh, specs)
        with StepCost() as cost, _replicated(mesh):
            step(*args)
    finally:
        logical.set_mesh(before[0])
        logical.set_rules(before[1])
    return cost


def place_args(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
               specs: Dict[str, Any]) -> list:
    """The step's arguments of ``specs``, each placed by its sharding."""
    args = []
    for name, sh in zip(STEP_ARGS[shape.kind],
                        shardings_for(cfg, shape, mesh, specs)):
        arg = specs[name]
        args.append(sh.place(arg) if isinstance(sh, S.NamedSharding)
                    else S.place(arg, sh))
    return args


def _replicated(mesh: Mesh):
    """On a walked mesh, DTensor's ``implicit_replication``: a plain
    tensor the step makes (positions, masks, an optimizer's scalars)
    meets the DTensors as replicated on every device, as a constant
    does under jit."""
    if not mesh.walked:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


#: the per-key dicts of a cell's counts
DICTS = ("kernel_flops", "kernel_calls", "collective_ops",
         "collective_bytes_by_op")


def _cell_costs(cost: StepCost) -> Dict[str, float]:
    return {"flops": cost.flops, "hbm_bytes": cost.hbm_bytes,
            "collective_wire_bytes": cost.collectives.total_wire_bytes,
            "kernel_flops": dict(cost.kernel_flops),
            "kernel_calls": dict(cost.kernel_calls),
            "collective_ops": dict(cost.collectives.ops),
            "collective_bytes_by_op": dict(cost.collectives.bytes_by_op)}


def _extrapolate(p1: Dict[str, Any], p2: Dict[str, Any], units: int
                 ) -> Dict[str, Any]:
    """p1 + (units - 1)(p2 - p1): exact, since a step's count is affine
    in its unit count (the dicts key by key)."""
    def line(a, b):
        return a + (units - 1) * (b - a)
    out: Dict[str, Any] = {key: line(p1[key], p2[key]) for key in TOTALS}
    for key in DICTS:
        out[key] = {k: line(p1[key].get(k, 0), p2[key].get(k, 0))
                    for k in sorted(set(p1[key]) | set(p2[key]))}
    return out


def step_costs(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
               optimizer: Optional[opt.Optimizer] = None,
               probes: bool = True) -> Dict[str, Any]:
    """The counts of ``cfg``'s step of ``shape`` (``TOTALS``, and each
    kernel's operations and calls): from its 1- and 2-unit probes, or
    with ``probes`` false from a walk of the whole config.  A train
    step takes ``optimizer``, the full config's ``opt.for_config`` by
    default, in the probes too."""
    optimizer = optimizer or opt.for_config(cfg)
    if not probes:
        return _cell_costs(walk(cfg, shape, mesh, optimizer))
    p1, p2 = (_cell_costs(walk(probe_config(cfg, k), shape, mesh, optimizer))
              for k in (1, 2))
    return _extrapolate(p1, p2, n_units(cfg))


def _card(card: Optional[str]) -> Tuple[str, float]:
    """(the card's name, its memory bytes): ``card`` from the peaks
    table, else the CUDA device's own."""
    if card is not None:
        return card, peaks_for(card).memory_bytes
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device to name the card: pass --card "
                           "(a name of launch/roofline.PEAKS)")
    name = torch.cuda.get_device_name(0)
    peaks_for(name)                       # a card the table lacks raises
    return name, float(torch.cuda.get_device_properties(0).total_memory)


@contextlib.contextmanager
def mesh_named(name: str) -> Iterator[Mesh]:
    """The mesh ``name`` of ``MESHES``: one ``meta`` device, or a walked
    mesh (its fake process group destroyed on exit, also on error)."""
    sizes = MESHES[name]
    if sizes == (1, 1):
        yield make_mesh(1, 1, device=steps.META)
        return
    with walked_mesh(sizes) as mesh:
        yield mesh


def seq_parallel_for(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """``cfg`` as the reference's dry run walks it on a production mesh:
    Megatron-style sequence parallelism for the prefills of dense and
    VLM models of width 3,500 and up (train and narrow models left
    off, as the reference measured them)."""
    if shape.kind == "prefill" and cfg.family in ("dense", "vlm") \
            and cfg.d_model >= 3500:
        return dataclasses.replace(cfg, seq_parallel=True)
    return cfg


def device_bytes(tree: Any) -> int:
    """Bytes of the tensors of ``tree`` that one device holds: a
    DTensor's local shard, a plain tensor whole."""
    leaves = [t for leaf in torch.utils._pytree.tree_leaves(tree)
              for t in (leaf.parameters() if isinstance(
                  leaf, torch.nn.Module) else (leaf,))]
    return sum(argument_bytes(t.to_local() if logical.is_sharded(t)
                              else t) for t in leaves
               if isinstance(t, torch.Tensor))


def run_cell(arch: str, shape_name: str, mesh_name: str = "h100_1x1",
             card: Optional[str] = None, save: bool = True,
             verbose: bool = True, probes: bool = True,
             directory: Path = RESULTS_DIR) -> Dict[str, Any]:
    """One cell's record.  ``probes=False`` walks the full config
    instead of its two probes.  ``argument_bytes`` and ``fits`` are one
    device's (the whole step's on ``h100_1x1``)."""
    cfg = C.get(arch)
    shape = SHAPES[shape_name]
    card, memory = _card(card)
    if mesh_name != "h100_1x1":
        cfg = seq_parallel_for(cfg, shape)

    if shape_name == "long_500k" and not cfg.sub_quadratic:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped",
               "reason": "pure full-attention arch: 500k dense-KV decode "
                         "is quadratic with no sparsity mechanism "
                         "(DESIGN.md Arch-applicability)"}
        if save:
            _save(rec, directory)
        return rec

    t0 = time.perf_counter()
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name,
                           "chips": math.prod(MESHES[mesh_name]),
                           "kind": shape.kind, "card": card,
                           "seq_parallel": cfg.seq_parallel}
    try:
        with mesh_named(mesh_name) as mesh:
            _walk_cell(rec, cfg, shape, mesh, memory, probes)
        rec["walk_s"] = time.perf_counter() - t0
        if verbose:
            fc = rec.get("flops_corrected", rec.get("flops"))
            hc = rec.get("hbm_bytes_corrected", rec.get("hbm_bytes"))
            cc = rec.get("collective_wire_bytes_corrected",
                         rec.get("collective_wire_bytes"))
            print(f"[ok] {arch} x {shape_name} x {mesh_name}: "
                  f"flops={fc:.3e} bytes={hc:.3e}B coll={cc:.3e}B "
                  f"args={rec['argument_bytes']:.3e}B "
                  f"fits={rec['fits']} ({rec['walk_s']:.2f}s)")
    except Exception as ex:
        rec.update({"status": "error", "error": f"{type(ex).__name__}: "
                    f"{ex}"[:2000]})
        if verbose:
            print(f"[ERR] {arch} x {shape_name} x {mesh_name}: {ex}")
            traceback.print_exc()

    if save:
        _save(rec, directory)
    return rec


def _walk_cell(rec: Dict[str, Any], cfg: ModelConfig, shape: ShapeSpec,
               mesh: Mesh, memory: float, probes: bool) -> None:
    """Fill ``rec`` with the cell's argument bytes a device, whether they
    fit ``memory``, and its counts (``step_costs``)."""
    optimizer = opt.for_config(cfg)
    specs = steps.input_specs(cfg, shape, optimizer)
    arg_bytes = device_bytes(place_args(cfg, shape, mesh, specs))
    rec.update({"status": "ok", "optimizer": optimizer.name
                if shape.kind == "train" else None,
                "argument_bytes": arg_bytes,
                "memory_bytes": memory,
                "fits": arg_bytes <= memory})
    del specs
    costs = step_costs(cfg, shape, mesh, optimizer, probes)
    # the port has no scan, so a walk of the whole config counts what the
    # probes extrapolate (tests/test_torch_dryrun.py): the keys that the
    # reference fills from its whole compile hold the same numbers
    rec.update(costs)
    if probes:
        rec.update({k + "_corrected": v for k, v in costs.items()})


def _cell_in_child(args) -> Tuple[Dict[str, Any], bool]:
    """``run_cell(*args)`` in a pool's process: (its record, whether it
    left a process group initialised)."""
    import torch.distributed as dist
    rec = run_cell(*args)
    return rec, dist.is_initialized()


def run_cells(cells: Sequence[Tuple[str, str, str]], card: str,
              save: bool = True, verbose: bool = True,
              directory: Path = RESULTS_DIR) -> list:
    """The records of ``cells`` ((arch, shape, mesh) each), in order: one
    cell in this process, more in a pool of spawned processes, one a
    host core up to one a cell, each walking one cell at a time (a walk
    runs on one thread; the pool is shut down before this returns).
    Raises if a cell leaves a process group behind."""
    args = [(a, s, m, card, save, verbose, True, directory)
            for a, s, m in cells]
    jobs = min(len(cells), len(os.sched_getaffinity(0)))
    if jobs <= 1:
        out = [_cell_in_child(a) for a in args]
    else:
        import concurrent.futures
        import multiprocessing
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=jobs,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            out = list(pool.map(_cell_in_child, args))
    left = [c for c, (_, pg) in zip(cells, out) if pg]
    if left:
        raise RuntimeError(f"a process group was left by {left}")
    return [rec for rec, _ in out]


def _save(rec: Dict[str, Any], directory: Path = RESULTS_DIR) -> None:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    (directory / name).write_text(json.dumps(rec, indent=2))


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Count every cell's step on the meta device: runs on "
                    "the host and needs no card.")
    ap.add_argument("--arch", choices=C.ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=list(MESHES) + ["both"],
                    default="h100_1x1",
                    help="a mesh, or both of the reference's production "
                         "meshes (pod_16x16, multipod_2x16x16)")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--archs", type=str, default=None,
                    help="comma-separated arch subset (with --all)")
    ap.add_argument("--card", type=str, default=None,
                    help="the card whose memory the arguments must fit "
                         "(a name of launch/roofline.PEAKS, e.g. \"H100 "
                         "80GB HBM3\"); default: the CUDA device")
    ap.add_argument("--dir", type=Path, default=RESULTS_DIR,
                    help=f"where the records go (default {RESULTS_DIR})")
    args = ap.parse_args(argv)

    if args.all:
        archs = (args.archs.split(",") if args.archs else C.ARCH_IDS)
        pairs = [(a, s) for a in archs for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        pairs = [(args.arch, args.shape)]

    meshes = BOTH if args.mesh == "both" else (args.mesh,)
    t0 = time.perf_counter()
    recs = run_cells([(a, s, m) for a, s in pairs for m in meshes],
                     card=_card(args.card)[0],
                     directory=args.dir)
    n_ok = sum(r["status"] == "ok" for r in recs)
    n_skip = sum(r["status"] == "skipped" for r in recs)
    n_err = sum(r["status"] == "error" for r in recs)
    print(f"\ndry-run summary: ok={n_ok} skipped={n_skip} errors={n_err} "
          f"in {time.perf_counter() - t0:.1f} s")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
