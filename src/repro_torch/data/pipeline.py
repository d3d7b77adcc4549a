"""Deterministic, sharded, checkpointable data pipeline (the reference's
``data/pipeline.py``; host numpy, so the token stream is the
reference's bit for bit).

Design constraints at 1000-node scale:
  * every host must independently produce ITS shard of the global batch
    without coordination (pure function of (seed, step, host_id));
  * restart from a checkpoint must resume the exact token stream
    (the pipeline state is just the step counter);
  * elastic rescaling must keep the global stream identical (sharding
    is by global example index, not host-local counters).

There is no corpus: examples are synthesized from a splitmix64-style
counter hash of (seed, global example index, position) -- statistically
stationary, deterministic, and reproducible across any host layout.  A
real deployment swaps ``_example_tokens`` for a tokenized-shard reader
with the same indexing contract.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Sequence

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # modality stubs
    n_patches: int = 0
    enc_frames: int = 0
    d_model: int = 0


class ShardedSyntheticDataset:
    """Counter-mode synthetic LM stream.

    ``batch_slice(step, lo, hi)`` returns examples [lo, hi) of the
    global batch at ``step`` -- hosts call it with their own range.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    # ------------------------------------------------------------------ #
    def _example_tokens(self, idx: np.ndarray) -> np.ndarray:
        """Deterministic tokens for global example indices ``idx``
        ([n] int64) -> [n, seq_len+1] int32."""
        c = self.cfg
        # splitmix-style counter hash, vectorized over (example, position);
        # uint64 arithmetic wraps by design
        pos = np.arange(c.seq_len + 1, dtype=np.uint64)[None, :]
        with np.errstate(over="ignore"):
            x = (idx.astype(np.uint64)[:, None]
                 * np.uint64(0x9E3779B97F4A7C15)
                 + pos * np.uint64(0xBF58476D1CE4E5B9)
                 + np.uint64(c.seed) * np.uint64(0x94D049BB133111EB))
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
        return (x % np.uint64(self.cfg.vocab)).astype(np.int32)

    def batch_slice(self, step: int, lo: int, hi: int
                    ) -> Dict[str, np.ndarray]:
        c = self.cfg
        base = np.int64(step) * c.global_batch
        idx = base + np.arange(lo, hi, dtype=np.int64)
        toks = self._example_tokens(idx)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if c.n_patches:
            rng = np.random.default_rng(c.seed * 1_000_003 + step)
            out["patches"] = rng.standard_normal(
                (hi - lo, c.n_patches, c.d_model)).astype(np.float32)
        if c.enc_frames:
            rng = np.random.default_rng(c.seed * 1_000_033 + step)
            out["frames"] = rng.standard_normal(
                (hi - lo, c.enc_frames, c.d_model)).astype(np.float32)
        return out

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        return self.batch_slice(step, 0, self.cfg.global_batch)

    # ------------------------------------------------------------------ #
    def iterate(self, start_step: int = 0,
                host_id: int = 0, n_hosts: int = 1
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Host-local shard stream, resumable at any step."""
        c = self.cfg
        per = c.global_batch // n_hosts
        lo, hi = host_id * per, (host_id + 1) * per
        step = start_step
        while True:
            yield self.batch_slice(step, lo, hi)
            step += 1


def mix_datasets(streams: Sequence[Iterator[Dict[str, np.ndarray]]],
                 weights: Sequence[float], seed: int = 0
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic weighted mixture of example streams."""
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    rng = np.random.default_rng(seed)
    while True:
        k = int(rng.choice(len(streams), p=w))
        yield next(streams[k])
