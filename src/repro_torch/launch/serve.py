"""Batched serving loop: continuous-batching decode (the reference's
``launch/serve.py``).

    python -m repro_torch.launch.serve --arch qwen2-7b --requests 8
    python -m repro_torch.launch.serve --arch mamba2-1.3b --smoke --device cpu

Slot-based continuous batching: a fixed decode batch of ``--batch``
slots; finished requests release their slot, queued requests claim it
(prefill-on-slot by streaming the prompt through the decode step, as
the reference does).  Runs on the CUDA device unless ``--device`` names
another.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
from torch import nn

import repro_torch.configs as C
from repro_torch.kernels.backends import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import api


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


class Server:
    """Slot-based continuous batching on a fixed decode batch.

    ``params`` defaults to the seed-0 weights of ``api.init``; pass a
    module (e.g. weights carried from the reference) to serve those.
    The cache comes from ``api.init_cache``; an encoder-decoder's cross
    cache stays zero until ``encdec.prime_cache`` fills it, as in the
    reference.
    """

    def __init__(self, cfg, batch: int = 4, max_len: int = 256,
                 params: Optional[nn.Module] = None, device=None):
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(self.device).manual_seed(0)
            params = api.init(cfg, gen, self.device)
        self.params = params
        self.cache = api.init_cache(cfg, batch, max_len, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch
        self.pos = np.zeros(batch, np.int64)
        self.queue: List[Request] = []
        self._step = make_serve_step(cfg, self.device)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    # ------------------------------------------------------------------ #
    def _fill_slots(self) -> None:
        for i in range(self.batch):
            if self.slot_req[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[i] = req
                # prefill the slot by streaming prompt tokens (cache
                # warmup through the decode path, as the reference does)
                self.pos[i] = 0
                for tok in req.prompt[:-1]:
                    self._advance_slot(i, tok)
                req._next = req.prompt[-1]

    def _advance_slot(self, i: int, tok: int) -> None:
        # the reference returns this step's argmax, which no caller reads;
        # taking it here would sync the host on every prompt token
        toks = np.zeros(self.batch, np.int64)
        toks[i] = tok
        _, self.cache = self._step(
            self.params, self.cache, torch.from_numpy(toks),
            torch.from_numpy(self.pos))
        self.pos[i] += 1

    def step(self) -> None:
        """One fleet decode step for every active slot."""
        self._fill_slots()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return
        toks = np.zeros(self.batch, np.int64)
        for i in active:
            toks[i] = getattr(self.slot_req[i], "_next", 0)
        logits, self.cache = self._step(
            self.params, self.cache, torch.from_numpy(toks),
            torch.from_numpy(self.pos))
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for i in active:
            req = self.slot_req[i]
            self.pos[i] += 1
            req.out.append(int(nxt[i]))
            req._next = int(nxt[i])
            if (len(req.out) >= req.max_new
                    or self.pos[i] >= self.max_len - 1):
                req.done = True
                self.slot_req[i] = None

    def drain(self) -> None:
        while self.queue or any(r is not None for r in self.slot_req):
            self.step()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=C.ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()

    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    server = Server(cfg, batch=args.batch, device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(4, 12)
                              ).tolist()
        server.submit(Request(rid, prompt, args.max_new))
    server.drain()
    if server.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    total = args.requests * args.max_new
    print(f"served {args.requests} requests, {total} tokens "
          f"in {dt:.2f}s ({total / dt:.1f} tok/s) on {server.device}")


if __name__ == "__main__":
    main()
