"""Time the one-card model steps of two checkouts on one card, in turns.

    python -m repro_torch.bench.steps_ab --base DIR [--pairs 2] [--only NAME ...] [--smoke]

``DIR`` is another checkout of this repository (the parent commit, for
example, unpacked with ``git archive`` under the ignored ``build/``).
Each checkout's package runs in a process of its own (its ``src`` on
``PYTHONPATH``, its own kernel builds), in ``--pairs`` pairs whose
order alternates (base, this, this, base, ...), so that both come from
one card and one host.  Each process times,
on seeded random weights, through the entry points a user calls
(``launch/steps``):

  * the bf16 prefill of 4 x 2048 tokens (Whisper: 4 x 448 over its
    1,500 frames) of Qwen2-7B at 8 of its 28 layers, Mamba2-1.3B,
    Qwen2-MoE-A2.7B at 4 of its 24 layers and Whisper-small: prompt
    tokens/s;
  * the decode step at batch 1 (``make_serve_step``, a cache of 512
    slots, Whisper's 448) of OLMo-1B in fp32 and bf16, Mamba2-1.3B in
    fp32 and Whisper-small in fp32 (its cross cache primed first): ms a
    step, over 64 steps;
  * the bf16 train step (AdamW by ``for_config``, remat on) of OLMo-1B
    at 8 x 2048 and Whisper-small at 8 x 448: s a step.

Each measurement is the median of ``REPS`` runs after one warm-up, on
the host clock, synced (what a user waits for).  ``--smoke`` runs the
smoke configs at sizes of 32 at most on the CPU, a check of the script
itself.  Prints the card's name
and power limit, one line per measurement and process, and a JSON
summary last: per case the base's and this tree's medians over their
processes, every process's reading, and the pairs this tree won.
``--only`` keeps the cases whose names start with one of its words
(``decode``, ``train whisper``), for more pairs of the host-bound ones.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]

#: timed runs a measurement, after one warm-up
REPS = 5
#: (name, arch, layers or None, dtype, batch, seq)
PREFILLS = (("prefill qwen2-7b x8", "qwen2-7b", 8, "bfloat16", 4, 2048),
            ("prefill mamba2-1.3b", "mamba2-1.3b", None, "bfloat16", 4,
             2048),
            ("prefill qwen2-moe-a2.7b x4", "qwen2-moe-a2.7b", 4, "bfloat16",
             4, 2048),
            ("prefill whisper-small", "whisper-small", None, "bfloat16", 4,
             448))
#: (name, arch, layers or None, dtype, cache slots, steps)
DECODES = (("decode olmo-1b fp32", "olmo-1b", None, "float32", 512, 64),
           ("decode olmo-1b bf16", "olmo-1b", None, "bfloat16", 512, 64),
           ("decode mamba2-1.3b fp32", "mamba2-1.3b", None, "float32", 512,
            64),
           ("decode whisper-small fp32", "whisper-small", None, "float32",
            448, 64))
#: (name, arch, layers or None, batch, seq)
TRAINS = (("train olmo-1b", "olmo-1b", None, 8, 2048),
          ("train whisper-small", "whisper-small", None, 8, 448))

#: the child: its own checkout's package times every case
_CHILD = r"""
import dataclasses, json, statistics, sys, time
import torch
import repro_torch.configs as C
from repro_torch.launch import steps as ST
from repro_torch.models import api
from repro_torch.optim import optimizers as opt

cases, reps, device, smoke = json.loads(sys.argv[1])
device = torch.device(device)


def sync():
    if device.type == "cuda":
        torch.cuda.synchronize()


def small(*sizes):            # a smoke run's sizes: each at most 32
    return [min(n, 32) for n in sizes] if smoke else list(sizes)


def config(arch, layers, dtype):
    cfg = C.get_smoke(arch) if smoke else C.get(arch)
    kw = {"dtype": dtype}
    if layers and not smoke:
        kw["n_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def batch_of(cfg, b, s, seed):
    data = api.make_batch(cfg, torch.Generator(device).manual_seed(seed),
                          b, s)
    wide = getattr(torch, cfg.dtype)
    return {k: v.to(wide) if v.is_floating_point() else v
            for k, v in data.items()}


def timed(fn):
    fn()
    sync()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


res = {}
for name, arch, layers, dtype, b, s in cases["prefill"]:
    b, s = small(b, s)
    cfg = config(arch, layers, dtype)
    params = api.init(cfg, torch.Generator(device).manual_seed(0), device)
    data = batch_of(cfg, b, s, 1)
    data.pop("labels")
    step = ST.make_prefill_step(cfg, device)
    sec = timed(lambda: step(params, data))
    res[name] = {"tokens_per_s": b * s / sec}
    del params, data
for name, arch, layers, dtype, slots, n in cases["decode"]:
    slots, n = small(slots, n)
    cfg = config(arch, layers, dtype)
    params = api.init(cfg, torch.Generator(device).manual_seed(0), device)
    step = ST.make_serve_step(cfg, device)
    toks = torch.randint(0, cfg.vocab, (1, n),
                         generator=torch.Generator(device).manual_seed(2),
                         device=device)
    wide = getattr(torch, dtype)
    if cfg.family == "encdec":
        from repro_torch.models import encdec
        frames = batch_of(cfg, 1, 8, 3)["frames"]

    def run():
        cache = api.init_cache(cfg, 1, slots, dtype=wide, device=device)
        if cfg.family == "encdec":
            with torch.inference_mode():
                cache = encdec.prime_cache(cfg, params, cache, frames)
        sync()
        t0 = time.perf_counter()
        for t in range(n):
            _, cache = step(params, cache, toks[:, t], torch.full((1,), t))
        sync()
        return time.perf_counter() - t0
    run()
    res[name] = {"ms_a_step": 1e3 * statistics.median(
        run() for _ in range(reps)) / n}
    del params
for name, arch, layers, b, s in cases["train"]:
    b, s = small(b, s)
    cfg = config(arch, layers, "bfloat16")
    params = api.init(cfg, torch.Generator(device).manual_seed(0), device)
    optimizer = opt.for_config(cfg)
    state = [optimizer.init(dict(params.named_parameters()))]
    data = batch_of(cfg, b, s, 1)
    step = ST.make_train_step(cfg, optimizer, device=device)

    def one():
        global params
        params, state[0], m = step(params, state[0], data)
        float(m["loss"])
    res[name] = {"s_a_step": timed(one)}
    del params, state
print(json.dumps(res))
"""


def run_checkout(root: Path, smoke: bool, only=None) -> dict:
    """The cases (those named by ``only``, else all) timed by the package
    of the checkout at ``root``."""
    cases = {kind: [c for c in group
                    if not only or c[0].startswith(tuple(only))]
             for kind, group in (("prefill", PREFILLS), ("decode", DECODES),
                                 ("train", TRAINS))}
    env = dict(os.environ, PYTHONPATH=str(Path(root) / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD,
         json.dumps([cases, REPS, "cpu" if smoke else "cuda", smoke])],
        cwd=root, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def card() -> str:
    """``nvidia-smi``'s name and power limit, or ``none``."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "none"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, required=True,
                    help="the other checkout (its src/ is imported)")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs at sizes of 32 at most, on the "
                         "CPU")
    ap.add_argument("--pairs", type=int, default=2,
                    help="pairs of processes, base first in the even ones")
    ap.add_argument("--only", nargs="+", default=None,
                    help="the cases whose names start with these words")
    args = ap.parse_args(argv)
    print(f"card: {card()}", flush=True)
    runs = {"base": [], "this": []}
    for i in range(args.pairs):
        for who in ("base", "this") if i % 2 == 0 else ("this", "base"):
            root = args.base.resolve() if who == "base" else ROOT
            got = run_checkout(root, args.smoke, args.only)
            runs[who].append(got)
            for name, rec in got.items():
                print(f"{who} {name}: {json.dumps(rec)}", flush=True)
    summary = {}
    for name in runs["this"][0]:
        key = next(iter(runs["this"][0][name]))
        got = {who: [r[name][key] for r in recs]
               for who, recs in runs.items()}
        better = max if key == "tokens_per_s" else min
        summary[name] = {
            "metric": key,
            **{who: statistics.median(v) for who, v in got.items()},
            "this_won": sum(better(a, b) == b and a != b
                            for a, b in zip(got["base"], got["this"])),
            "runs": got}
    print(json.dumps({"card": card(), "cases": summary}))


if __name__ == "__main__":
    main()
