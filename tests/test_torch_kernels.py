"""The port's seam kernels against the reference.

* The plain versions of ``search``, ``merge_path`` and
  ``multi_merge_ranks`` against the Pallas kernels they replace
  (interpret mode), on int32-admissible inputs, real slots only, exact.
* ``TorchKernels`` on the CPU against the reference ``NumpyKernels`` on
  the adversarial key domains and the three semirings, bit-identical.
* The wrappers: plain versions on CPU tensors, no silent way around the
  kernel on any other device, guarded dispatch that records every fault.

The kernels themselves are held to their plain versions on the card by
tests/test_torch_cuda.py (no JAX there, so it runs where the card is).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.einsum import Semiring as RefSemiring
from repro.kernels import intersect as ref_isect
from repro.kernels import ops as ref_ops
from repro.kernels.backends import NumpyKernels
from repro_torch.core.einsum import Semiring
from repro_torch.kernels import (merge_path, merge_path_plain,
                                 multi_merge_ranks, multi_merge_ranks_plain,
                                 search, search_plain)
from repro_torch.kernels import backends as tkb

I32_MAX = np.iinfo(np.int32).max


def _sorted_keys(rng, lo, hi, n):
    n = min(n, hi - lo)
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    return np.sort(lo + rng.choice(hi - lo, size=n, replace=False))


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


# ---------------------------------------------------------------------- #
# plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("na,nb,lo,hi", [
    (200, 300, 0, 1000),                   # dense overlap
    (64, 500, 0, 100_000),                 # sparse
    (150, 150, I32_MAX - 400, I32_MAX),    # hugging the int32 pad value
    (0, 40, 0, 100),                       # empty probes
])
def test_search_plain_matches_pallas_intersect(na, nb, lo, hi):
    rng = np.random.default_rng(na + nb)
    b = _sorted_keys(rng, lo, hi, nb)
    a = _sorted_keys(rng, lo, hi, na)
    ap = ref_ops.pad_sorted(a.astype(np.int32), 64)
    bp = ref_ops.pad_sorted(b.astype(np.int32), 64)
    want = np.asarray(ref_isect.intersect_sorted(
        jnp.asarray(ap), jnp.asarray(bp), block=64, interpret=True))[:na]
    got = search_plain(_t(b), _t(a)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("na,nb,lo,hi", [
    (120, 90, 0, 300),                     # many keys in both
    (256, 17, 0, 1 << 20),
    (50, 70, I32_MAX - 300, I32_MAX),
    (0, 33, 0, 100),
])
def test_merge_path_plain_matches_pallas_merge(na, nb, lo, hi):
    rng = np.random.default_rng(na * 7 + nb)
    a = _sorted_keys(rng, lo, hi, na)
    b = _sorted_keys(rng, lo, hi, nb)
    ap = ref_ops.pad_sorted(a.astype(np.int32), 64)
    bp = ref_ops.pad_sorted(b.astype(np.int32), 64)
    merged, src = ref_ops.merge_sorted(jnp.asarray(ap), jnp.asarray(bp),
                                       block=64, interpret=True)
    total = na + nb
    got_m, got_s = merge_path_plain(_t(a), _t(b))
    np.testing.assert_array_equal(got_m.numpy(),
                                  np.asarray(merged)[:total])
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(src)[:total])


@pytest.mark.parametrize("sizes,lo,hi", [
    ((40, 60, 25), 0, 200),                # duplicate-heavy
    ((100, 1, 50, 80), 0, 5000),
    ((0, 30, 30), 0, 100),                 # an empty row
    ((30, 45, 20), I32_MAX - 200, I32_MAX),
])
def test_multi_merge_plain_matches_pallas_ranks(sizes, lo, hi):
    rng = np.random.default_rng(sum(sizes))
    rows = [_sorted_keys(rng, lo, hi, n) for n in sizes]
    n_pad = max(len(ref_ops.pad_sorted(r.astype(np.int32), 32))
                for r in rows)
    stacked = np.stack([
        np.concatenate([r.astype(np.int32),
                        np.full(n_pad - len(r), I32_MAX, np.int32)])
        for r in rows])
    ranks = np.asarray(ref_ops.multi_merge_ranks(
        jnp.asarray(stacked), block=32, interpret=True))
    offs = np.cumsum([0] + [len(r) for r in rows])
    got = multi_merge_ranks_plain(_t(np.concatenate(rows)), _t(offs))
    for i, r in enumerate(rows):
        np.testing.assert_array_equal(got[offs[i]:offs[i + 1]].numpy(),
                                      ranks[i, :len(r)].astype(np.int64))


# ---------------------------------------------------------------------- #
# TorchKernels (CPU) against the reference NumpyKernels
# ---------------------------------------------------------------------- #
#: duplicate-heavy, empty, hugging INT32_MAX, packed int64 near 2^62
KEY_DOMAINS = [
    ("dense", 0, 500),
    ("empty", 0, 1),
    ("i32_boundary", I32_MAX - 400, I32_MAX),
    ("i64_packed", (1 << 62) - 2000, (1 << 62) - 1),
]


@pytest.mark.parametrize("dom", KEY_DOMAINS, ids=lambda d: d[0])
def test_torch_kernels_seam_parity(dom):
    _, lo, hi = dom
    rng = np.random.default_rng(11)
    ref = NumpyKernels()
    kb = tkb.TorchKernels("cpu")
    for trial in range(5):
        a, b, c, d = (_sorted_keys(rng, lo, hi, int(rng.integers(0, 300)))
                      for _ in range(4))
        np.testing.assert_array_equal(kb.intersect_keys(a, b),
                                      ref.intersect_keys(a, b))
        for got, want in zip(kb.union_keys(a, b), ref.union_keys(a, b)):
            np.testing.assert_array_equal(got, want)
        for arrays in ([a, b, c], [a, b, c, d], [a, c[:0], b]):
            u, pos = kb.union_k_keys(arrays)
            ur, posr = ref.union_k_keys(arrays)
            np.testing.assert_array_equal(u, ur)
            assert len(pos) == len(posr)
            for p, pr in zip(pos, posr):
                np.testing.assert_array_equal(p, pr)
        # duplicate-heavy probes in arbitrary order
        probes = rng.choice(np.concatenate([a, [lo, hi - 1]]),
                            size=200) if len(a) else \
            np.zeros(0, dtype=np.int64)
        np.testing.assert_array_equal(kb.lookup_keys(a, probes),
                                      ref.lookup_keys(a, probes))


@pytest.mark.parametrize("sr", ["arithmetic", "min_plus", "or_and"])
def test_torch_kernels_segmented_reduce_parity(sr):
    rng = np.random.default_rng(13)
    kb = tkb.TorchKernels("cpu")
    ref = NumpyKernels()
    semiring, ref_semiring = getattr(Semiring, sr)(), \
        getattr(RefSemiring, sr)()
    for n in (0, 1, 7, 1000):
        vals = (rng.random(n) * 2 - 1 if sr != "or_and"
                else (rng.random(n) < 0.5).astype(np.float64))
        cuts = np.sort(rng.choice(np.arange(1, max(n, 2)),
                                  size=min(n // 3, max(n - 1, 0)),
                                  replace=False)) if n > 1 else \
            np.zeros(0, dtype=np.int64)
        starts = np.concatenate([[0], cuts]).astype(np.int64) if n else \
            np.zeros(0, dtype=np.int64)
        got = kb.segmented_reduce(vals, starts, semiring)
        want = ref.segmented_reduce(vals, starts, ref_semiring)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------- #
# the wrappers and the guarded dispatch
# ---------------------------------------------------------------------- #
def test_wrappers_take_plain_versions_only_on_cpu():
    rng = np.random.default_rng(3)
    hay = _t(_sorted_keys(rng, 0, 1 << 40, 500))
    probes = _t(rng.integers(0, 1 << 40, size=300))
    counts = (search.launches, merge_path.launches,
              multi_merge_ranks.launches)
    assert torch.equal(search(hay, probes), search_plain(hay, probes))
    m = merge_path(hay, probes.sort().values.unique())
    m_plain = merge_path_plain(hay, probes.sort().values.unique())
    assert all(torch.equal(x, y) for x, y in zip(m, m_plain))
    offs = _t([0, 200, 500])
    assert torch.equal(multi_merge_ranks(hay, offs),
                       multi_merge_ranks_plain(hay, offs))
    # the counters count kernel launches, and the CPU launches none
    assert counts == (search.launches, merge_path.launches,
                      multi_merge_ranks.launches)
    # no device but the CPU and CUDA has a path: it raises, never
    # substitutes the plain version
    meta = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        search(meta, meta)
    with pytest.raises(ValueError, match="no kernel"):
        merge_path(meta, meta)
    with pytest.raises(ValueError, match="int64"):
        search(hay.to(torch.int32), probes)


def test_cuda_kernels_refuse_other_devices():
    with pytest.raises(ValueError):
        tkb.CudaKernels("cpu")
    assert isinstance(tkb.kernels_for(torch.device("cpu")), tkb.TorchKernels)
    assert isinstance(tkb.kernels_for(torch.device("cuda")),
                      tkb.CudaKernels)


class _Broken(tkb.TorchKernels):
    name = "broken"

    def intersect_keys(self, a, b):
        return super().intersect_keys(a, b)[:-1]     # one short


def test_guarded_dispatch_raises_and_records():
    """The chain holds the primary alone: a corrupted seam output is
    recorded and raised, never handed to another lowering."""
    tkb.reset_guard_state()
    try:
        g = tkb.GuardedKernels(_Broken("cpu"))
        a = np.arange(10, dtype=np.int64)
        with pytest.raises(tkb.KernelChainExhausted):
            g.intersect_keys(a, a)
        ev = g.pop_events()
        assert [e.action for e in ev] == ["downgrade"]
        assert ev[0].exc_type == "SeamPostconditionError"
        assert ev[0].fallback == ""
        np.testing.assert_array_equal(
            g.lookup_keys(a, a[::-1].copy()), a[::-1])
        # the third failure demotes the pair; later calls raise at once
        for _ in range(2):
            with pytest.raises(tkb.KernelChainExhausted):
                g.intersect_keys(a, a)
        assert [e.action for e in g.pop_events()] == \
            ["downgrade", "downgrade", "demote"]
        with pytest.raises(tkb.KernelChainExhausted, match="demoted"):
            g.intersect_keys(a, a)
        assert g.pop_events() == []
    finally:
        tkb.reset_guard_state()


def test_resolve_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkb.resolve_device(None)
    assert tkb.resolve_device("cpu").type == "cpu"
