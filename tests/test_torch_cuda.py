"""The port's CUDA kernels on the card (marked ``cuda``; they skip
without one).  This file imports neither JAX nor the reference, so it
runs on a GPU machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.accelerators import simulate
from repro_torch.core.trace import CollectingInstr
from repro_torch.kernels import (KERNELS, block_sparse_matmul,
                                 block_sparse_matmul_plain, compact_tiles,
                                 flash_attention, flash_attention_plain,
                                 merge_path, merge_path_plain,
                                 multi_merge_ranks, multi_merge_ranks_plain,
                                 search, search_plain, ssd_chunk,
                                 ssd_chunk_plain)
from test_torch_merge_tiling import DOMAINS as MERGE_DOMAINS
from test_torch_merge_tiling import sorted_rows as merge_rows

I32_MAX = (1 << 31) - 1
#: duplicate-heavy, empty, hugging INT32_MAX, packed int64 near 2^62, wide
KEY_DOMAINS = [("dense", 0, 500), ("empty", 0, 1),
               ("i32_boundary", I32_MAX - 400, I32_MAX),
               ("i64_packed", (1 << 62) - 2000, (1 << 62) - 1),
               ("wide", 0, 1 << 44)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    return torch.device("cuda")


def _keys(rng, lo, hi, n, device):
    n = min(n, hi - lo)
    keys = np.sort(lo + rng.choice(hi - lo, size=n, replace=False)) \
        if n > 0 else np.zeros(0, dtype=np.int64)
    return torch.from_numpy(keys.astype(np.int64)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dom", KEY_DOMAINS, ids=lambda d: d[0])
def test_kernels_match_plain_on_card(cuda_device, dom):
    _, lo, hi = dom
    rng = np.random.default_rng(5)
    for trial in range(3):
        rows = [_keys(rng, lo, hi, int(rng.integers(0, 3000)), cuda_device)
                for _ in range(3)]
        probes = torch.from_numpy(rng.integers(lo, hi, size=5000)) \
            .to(cuda_device)
        assert torch.equal(search(rows[0], probes),
                           search_plain(rows[0], probes))
        got = merge_path(rows[0], rows[1])
        want = merge_path_plain(rows[0], rows[1])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        cat = torch.cat(rows)
        offs = torch.tensor(np.cumsum([0] + [len(r) for r in rows]),
                            device=cuda_device)
        assert torch.equal(multi_merge_ranks(cat, offs),
                           multi_merge_ranks_plain(cat, offs))


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["gamma", "extensor", "outerspace",
                                    "sigma", "matraptor"])
def test_simulate_on_card_matches_cpu(cuda_device, design):
    rng = np.random.default_rng(1)
    n = 48
    a = rng.random((n, n)) * (rng.random((n, n)) < 0.15)
    b = rng.random((n, n)) * (rng.random((n, n)) < 0.15)
    shapes = {"m": n, "k": n, "n": n}
    runs = []
    for device in (cuda_device, "cpu"):
        for k in KERNELS:
            k.launches = 0
        ci = CollectingInstr()
        res = simulate(design, {"A": a, "B": b}, shapes, device=device,
                       extra_instr=ci)
        runs.append((res, ci, sum(k.launches for k in KERNELS)))
    (rc, cc, lc), (rp, cp, lp) = runs
    assert lc > 0 and lp == 0
    assert rc.fallback_reasons == {} and rc.downgrade_events == {}
    for name in rp.tensors:
        assert list(rc[name].iter_leaves()) == list(rp[name].iter_leaves())
    assert cc.touch_counts == cp.touch_counts
    assert cc.compute_counts == cp.compute_counts
    assert rc.report.seconds == rp.report.seconds


#: (B, nc, l, H, P, N): ragged row tiles (l 16, 100), the reference's
#: test shapes, head groups that do not divide H, P above one tile, N and
#: P off the tensor-core tiles (200, 40), P and N off 16-byte rows (21,
#: 37: element-wise loads and stores), and the prefill calls of
#: Mamba2-1.3B and of Jamba's Mamba layers (128 heads) at batch 1
SSD_CASES = [(1, 2, 16, 16, 16, 16), (2, 1, 100, 3, 24, 40),
             (1, 2, 64, 2, 32, 16), (2, 3, 128, 4, 64, 32),
             (1, 1, 256, 8, 64, 128), (1, 2, 512, 9, 96, 64),
             (1, 2, 128, 5, 40, 200), (1, 1, 100, 3, 21, 37),
             (1, 8, 256, 64, 64, 128), (1, 8, 256, 128, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_ssd_chunk_matches_plain_on_card(cuda_device, shape, dtype):
    """Both accumulate in fp32 from the same inputs: rtol = atol = 2e-4."""
    B, nc, l, H, P, N = shape
    gen = torch.Generator(cuda_device).manual_seed(3)

    def randn(*s):
        return torch.randn(s, generator=gen, device=cuda_device)

    x = randn(B, nc, l, H, P).to(dtype)
    a = -randn(B, H, nc, l).abs() * 0.1
    b, c = randn(B, nc, l, N).to(dtype), randn(B, nc, l, N).to(dtype)
    before = ssd_chunk.launches
    got = ssd_chunk(x, a, b, c)
    torch.cuda.synchronize()
    assert ssd_chunk.launches == before + 1
    torch.testing.assert_close(got, ssd_chunk_plain(x, a, b, c),
                               rtol=2e-4, atol=2e-4)


#: strong decay, a uniform in (-5, 0]: at l 256 most of L underflows to 0
SSD_DECAY_CASES = [(1, 2, 256, 8, 64, 128), (2, 1, 100, 3, 24, 40),
                   (1, 1, 512, 2, 32, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_DECAY_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_ssd_chunk_strong_decay_on_card(cuda_device, shape, dtype):
    """Decay down to exp(-5) a step: the entries of L that underflow are
    zeros, nothing overflows, and kernel and plain version agree at the
    same 2e-4."""
    B, nc, l, H, P, N = shape
    gen = torch.Generator(cuda_device).manual_seed(4)

    def randn(*s):
        return torch.randn(s, generator=gen, device=cuda_device)

    x = randn(B, nc, l, H, P).to(dtype)
    a = -5 * torch.rand(B, H, nc, l, generator=gen, device=cuda_device)
    b, c = randn(B, nc, l, N).to(dtype), randn(B, nc, l, N).to(dtype)
    cum = torch.cumsum(a.double(), -1)
    causal = torch.ones(l, l, dtype=torch.bool, device=cuda_device).tril()
    under = (cum[..., :, None] - cum[..., None, :] < -104)[..., causal]
    if l >= 256:
        assert float(under.double().mean()) > 0.5
    before = ssd_chunk.launches
    got = ssd_chunk(x, a, b, c)
    torch.cuda.synchronize()
    assert ssd_chunk.launches == before + 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ssd_chunk_plain(x, a, b, c),
                               rtol=2e-4, atol=2e-4)


#: the fp32 kernel (3xTF32, one CTA an SM): the longest chunk (l 512,
#: 212 KB of shared memory) at Mamba2's widths and off them, N and P off
#: the 16-column tiles and the 8-column steps (N 20, P 12; N 6 and P 10
#: off 16-byte rows too: element-wise loads and stores), l off the
#: 64-row tiles, and one head
SSD_FP32_CASES = [(1, 2, 512, 8, 64, 128), (1, 1, 512, 9, 40, 24),
                  (1, 1, 500, 3, 48, 72), (2, 1, 192, 3, 12, 20),
                  (1, 2, 256, 2, 10, 6), (1, 1, 64, 1, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_FP32_CASES, ids=str)
@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong"])
def test_ssd_chunk_fp32_kernel_on_card(cuda_device, shape, strong):
    """3xTF32 on G and Y: within 2e-4 (1 + |want|) of the plain version,
    under normal and strong decay."""
    B, nc, l, H, P, N = shape
    gen = torch.Generator(cuda_device).manual_seed(6)

    def randn(*s):
        return torch.randn(s, generator=gen, device=cuda_device)

    x = randn(B, nc, l, H, P)
    a = -5 * torch.rand(B, H, nc, l, generator=gen, device=cuda_device) \
        if strong else -randn(B, H, nc, l).abs() * 0.1
    b, c = randn(B, nc, l, N), randn(B, nc, l, N)
    before = ssd_chunk.launches
    got = ssd_chunk(x, a, b, c)
    torch.cuda.synchronize()
    assert ssd_chunk.launches == before + 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ssd_chunk_plain(x, a, b, c),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_smoke_prefill_on_card_launches_the_kernel(cuda_device):
    import repro_torch.configs as C
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import api
    cfg = C.get_smoke("mamba2-1.3b")
    params = api.init(cfg, torch.Generator(cuda_device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 64), device=cuda_device)
    ssd_chunk.launches = 0
    logits = make_prefill_step(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert ssd_chunk.launches == cfg.n_layers
    assert logits.shape == (2, 64, 512)
    assert bool(torch.isfinite(logits[..., :cfg.vocab]).all())


#: (b, h, hkv, sq, sk, d): the reference's ATTN_SHAPES, a ragged GQA-7
#: case at Qwen2-7B's head dim, and sq > sk
ATTN_CASES = [(1, 2, 2, 128, 128, 64), (2, 4, 2, 256, 256, 64),
              (1, 8, 1, 128, 256, 32), (2, 2, 2, 64, 192, 128),
              (1, 28, 4, 300, 300, 128), (2, 4, 1, 200, 70, 64)]
#: kernel vs plain: fp32 sums in another order (fp32); one bf16 rounding
#: of the output apart (bf16), the reference test's 2e-2
ATTN_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(shape, dtype, device, seed=0):
    b, h, hkv, sq, sk, d = shape
    gen = torch.Generator(device).manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device=device).to(dtype)
                 for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ATTN_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_matches_plain_on_card(cuda_device, shape, dtype,
                                               causal):
    q, k, v = _qkv(shape, dtype, cuda_device)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(),
                               flash_attention_plain(q, k, v, causal).float(),
                               rtol=0, atol=ATTN_ATOL[dtype])


@pytest.mark.cuda
def test_flash_attention_reads_strided_views_on_card(cuda_device):
    """[b, s, h, d] projections as [b, h, s, d] views, as ``mha`` passes
    them: read in place, output in q's layout, values as contiguous."""
    gen = torch.Generator(cuda_device).manual_seed(1)
    q = torch.randn(2, 100, 6, 64, generator=gen, device=cuda_device)
    kv = torch.randn(2, 100, 2, 1, 64, generator=gen, device=cuda_device)
    k = kv[..., 0, :].transpose(1, 2)
    v = (kv[..., 0, :] * 0.5).transpose(1, 2)
    got = flash_attention(q.transpose(1, 2), k, v)
    assert got.transpose(1, 2).is_contiguous()
    want = flash_attention(q.transpose(1, 2).contiguous(), k.contiguous(),
                           v.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(
        got, flash_attention_plain(q.transpose(1, 2), k, v),
        rtol=0, atol=2e-5)


#: the bf16 kernel (128-query blocks, 128-key tiles): (b, h, hkv, sq, sk,
#: d) at every head dim with lengths that are multiples of neither tile,
#: keys below one tile, sq < sk and sq > sk, GQA group 7, one key
BF16_CASES = [(2, 4, 2, 200, 333, 32), (1, 3, 3, 200, 333, 64),
              (1, 2, 1, 200, 333, 128), (2, 2, 1, 64, 40, 128),
              (1, 4, 2, 333, 200, 64), (1, 4, 4, 100, 260, 128),
              (1, 14, 2, 300, 300, 128), (1, 14, 2, 129, 1, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BF16_CASES, ids=str)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_bf16_kernel_on_card(cuda_device, shape, causal):
    """The tensor-core kernel rounds the softmax weights to bf16 for the
    PV product: within the reference test's 2e-2 of the fp32 plain
    version, one launch per call."""
    q, k, v = _qkv(shape, torch.bfloat16, cuda_device, seed=7)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(),
                               flash_attention_plain(q, k, v, causal).float(),
                               rtol=0, atol=2e-2)


def _strided_qkv(layout, device):
    """q [2, 14, 150, 128] and k, v [2, 2, 150, 128] bf16 as ``mha``
    passes them: [b, h, s, d] views of [b, s, h, d] projections.
    ``pad`` widens each head row by 4 elements (head stride 132: off the
    16-byte rule); ``offset`` starts the storage one element in (base off
    16 bytes).  Both take the copy; ``views`` is read in place."""
    gen = torch.Generator(device).manual_seed(2)
    w = 132 if layout == "pad" else 128
    n = 2 * 150 * 14 * w + 2 * 150 * 2 * 2 * w
    flat = torch.randn(n + 1, generator=gen, device=device).bfloat16()
    flat = flat[1:] if layout == "offset" else flat[:n]
    qf = flat[:2 * 150 * 14 * w].view(2, 150, 14, w)
    kvf = flat[2 * 150 * 14 * w:].view(2, 150, 2, 2, w)
    return (qf[..., :128].transpose(1, 2),
            kvf[..., 0, :128].transpose(1, 2),
            kvf[..., 1, :128].transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["views", "pad", "offset"])
def test_flash_attention_bf16_strided_views_on_card(cuda_device, layout):
    q, k, v = _strided_qkv(layout, cuda_device)
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    # in place, the output keeps q's [b, s, h, d] layout
    assert got.transpose(1, 2).is_contiguous() == (layout == "views")
    torch.testing.assert_close(got.float(),
                               flash_attention_plain(q, k, v).float(),
                               rtol=0, atol=2e-2)
    # the same arithmetic as on contiguous copies
    want = flash_attention(*(t.contiguous() for t in (q, k, v)))
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_flash_attention_bf16_empty_batch_on_card(cuda_device):
    """Nothing to compute: an empty result and no launch."""
    q, k, v = _qkv((0, 14, 2, 64, 64, 128), torch.bfloat16, cuda_device)
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert flash_attention.launches == before


#: the fp32 kernel (3xTF32 on wgmma; 128-query blocks, 64-key tiles or
#: 32 at d 128): (b, h, hkv, sq, sk, d) at every head dim with lengths
#: that are multiples of neither tile, keys below one tile, sq < sk and
#: sq > sk, GQA group 7, one key, one query, and Whisper's decoder
#: self-attention (causal) at batch 1
FP32_CASES = [(2, 4, 2, 200, 333, 32), (1, 3, 3, 200, 333, 64),
              (1, 2, 1, 200, 333, 128), (2, 2, 1, 64, 40, 128),
              (1, 4, 2, 333, 200, 64), (1, 4, 4, 100, 260, 128),
              (1, 14, 2, 300, 300, 128), (1, 14, 2, 129, 1, 32),
              (2, 3, 3, 1, 333, 64), (1, 12, 12, 448, 448, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FP32_CASES, ids=str)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_fp32_kernel_on_card(cuda_device, shape, causal):
    """The 3xTF32 kernel: within the fp32 limit, 2e-5, of the plain
    version, one launch per call."""
    q, k, v = _qkv(shape, torch.float32, cuda_device, seed=8)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, flash_attention_plain(q, k, v, causal),
                               rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_flash_attention_fp32_values_with_a_shared_mean_on_card(cuda_device):
    """Whisper's cross-attention at batch 1 (128 queries over 1500 frames)
    with values offset by 2.5, as the encoder's share a mean: each key
    tile's P V is accumulated apart and added to O with rounding, so the
    tensor cores' truncation does not compound over the 24 tiles."""
    q, k, v = _qkv((1, 12, 12, 128, 1500, 64), torch.float32, cuda_device,
                   seed=9)
    v = v + 2.5
    got = flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(got, flash_attention_plain(q, k, v, False),
                               rtol=0, atol=2e-5)


def _strided_qkv32(layout, device):
    """q [2, 12, 150, 64] and k, v [2, 4, 150, 64] fp32 as ``mha`` passes
    them: [b, h, s, d] views of [b, s, h, d] projections.  ``pad`` widens
    each head row by 2 elements (head stride 66: off the 16-byte rule);
    ``offset`` starts the storage one element in.  Both take the copy;
    ``views`` is read in place."""
    gen = torch.Generator(device).manual_seed(3)
    w = 66 if layout == "pad" else 64
    n = 2 * 150 * 12 * w + 2 * 150 * 4 * 2 * w
    flat = torch.randn(n + 1, generator=gen, device=device)
    flat = flat[1:] if layout == "offset" else flat[:n]
    qf = flat[:2 * 150 * 12 * w].view(2, 150, 12, w)
    kvf = flat[2 * 150 * 12 * w:].view(2, 150, 4, 2, w)
    return (qf[..., :64].transpose(1, 2), kvf[..., 0, :64].transpose(1, 2),
            kvf[..., 1, :64].transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["views", "pad", "offset"])
def test_flash_attention_fp32_strided_views_on_card(cuda_device, layout):
    q, k, v = _strided_qkv32(layout, cuda_device)
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    # in place, the output keeps q's [b, s, h, d] layout
    assert got.transpose(1, 2).is_contiguous() == (layout == "views")
    torch.testing.assert_close(got, flash_attention_plain(q, k, v),
                               rtol=0, atol=2e-5)
    # the same arithmetic as on contiguous copies
    want = flash_attention(*(t.contiguous() for t in (q, k, v)))
    assert torch.equal(got, want)


#: (M, K, N, bm, bk, bn, tile density): the reference's BSMM_SHAPES (the
#: last with an empty A), tile-rows of three 64-row CTAs and a ragged N
BSMM_CASES = [(128, 128, 128, 64, 64, 64, 0.5),
              (256, 128, 192, 64, 64, 64, 0.3),
              (256, 256, 64, 128, 128, 64, 0.2),
              (128, 256, 128, 64, 128, 128, 0.0),
              (384, 160, 100, 192, 32, 128, 0.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BSMM_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_block_sparse_matmul_matches_plain_on_card(cuda_device, case, dtype):
    """Both accumulate the same products in fp32, in another order:
    1e-4 sqrt(K) relative to |Z|."""
    M, K, N, bm, bk, bn, density = case
    rng = np.random.default_rng(2)
    a = rng.standard_normal((M, K)).astype(np.float32)
    a *= np.kron(rng.random((M // bm, K // bk)) < density,
                 np.ones((bm, bk), np.float32))
    tiles, rows, cols = (torch.from_numpy(x).to(cuda_device)
                         for x in compact_tiles(a, bm, bk))
    tiles = tiles.to(dtype)
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)) \
        .to(cuda_device, dtype)
    before = block_sparse_matmul.launches
    got = block_sparse_matmul(tiles, rows, cols, b, m=M, bn=bn)
    torch.cuda.synchronize()
    assert block_sparse_matmul.launches == before + 1
    want = block_sparse_matmul_plain(tiles, rows, cols, b, M)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * K ** 0.5 * scale)


#: (A tiles, B) dtype pairs the kernel takes
BSMM_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]
#: (M, K, N, bm, bk, tile density, scale): tile-rows of 40+ tiles, K not a
#: multiple of bk (the last tile column reads past B's last row), values
#: near 1e4, and a ragged N with bm 192 under bf16 rows
BSMM_STRESS = [(256, 3072, 256, 128, 64, 0.95, 1.0),
               (192, 200, 136, 64, 64, 0.8, 1.0),
               (320, 300, 100, 64, 128, 0.7, 1.0),
               (256, 512, 256, 128, 128, 0.6, 1e4),
               (384, 160, 100, 192, 32, 0.5, 1e4)]


def _ids(p):
    return "/".join(str(d).split(".")[-1] for d in p)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BSMM_STRESS, ids=str)
@pytest.mark.parametrize("pair", BSMM_PAIRS, ids=_ids)
def test_block_sparse_matmul_dtype_pairs_on_card(cuda_device, case, pair):
    """Every dtype pair on the tensor-core routes (3xTF32, 2xTF32, bf16)
    within the unchanged limit 1e-4 sqrt(K) max |Z|; K is padded to
    whole tiles in A and not in B."""
    M, K, N, bm, bk, density, scale = case
    rng = np.random.default_rng(4)
    kp = -(-K // bk) * bk
    a = np.zeros((M, kp), np.float32)
    a[:, :K] = rng.uniform(0.5, 1.5, (M, K)) * rng.choice([-1, 1], (M, K)) \
        * scale
    mask = rng.random((M // bm, kp // bk)) < density
    mask[0] = True                               # one full tile-row
    a *= np.kron(mask, np.ones((bm, bk), np.float32))
    tiles, rows, cols = (torch.from_numpy(x).to(cuda_device)
                         for x in compact_tiles(a, bm, bk))
    tiles = tiles.to(pair[0])
    b = torch.from_numpy((rng.uniform(0.5, 1.5, (K, N)) *
                          rng.choice([-1, 1], (K, N)) * scale)
                         .astype(np.float32)).to(cuda_device, pair[1])
    got = block_sparse_matmul(tiles, rows, cols, b, m=M)
    want = block_sparse_matmul_plain(tiles, rows, cols, b, M)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert int(torch.bincount(rows.long()).max()) >= min(40, kp // bk)
    scale_z = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * K ** 0.5 * scale_z)


@pytest.mark.cuda
def test_block_sparse_matmul_empty_tile_rows_on_card(cuda_device):
    """Tile-rows without a tile come out zero, without a padding tile."""
    rng = np.random.default_rng(5)
    tiles = torch.from_numpy(rng.standard_normal((3, 64, 64))
                             .astype(np.float32)).to(cuda_device)
    rows = torch.tensor([1, 1, 3], device=cuda_device)
    cols = torch.tensor([0, 2, 1], device=cuda_device)
    b = torch.from_numpy(rng.standard_normal((192, 128)).astype(np.float32)) \
        .to(cuda_device)
    got = block_sparse_matmul(tiles, rows, cols, b, m=320)
    want = block_sparse_matmul_plain(tiles, rows, cols, b, 320)
    assert torch.equal(got[:64], torch.zeros_like(got[:64]))
    assert torch.equal(got[128:192], torch.zeros_like(got[128:192]))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * 192 ** 0.5
                               * float(want.abs().max()))


def _search_case(name, rng, device):
    """(hay, probes) of one named adversarial case for ``search``: 2,048
    probes make a block of the kernel, 4,096 keys a window chunk."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)) \
            .to(device)

    def keys(lo, hi, n):
        return np.unique(rng.integers(lo, hi, n))

    if name == "wide_window":        # sorted probes sparse in 2M keys
        hay = keys(0, 1 << 40, 2_000_000)
        probes = np.sort(np.concatenate([rng.choice(hay, 3000),
                                         rng.integers(0, 1 << 40, 3000)]))
    elif name == "chunked_window":   # windows of 2-4 chunks
        hay = keys(0, 1 << 30, 300_000)
        probes = np.sort(np.concatenate([rng.choice(hay, 20_000),
                                         rng.integers(0, 1 << 30, 20_000)]))
        probes = probes[::3]
    elif name == "straddle":         # equal runs across block edges
        hay = keys(0, 50_000, 20_000)
        probes = np.sort(np.repeat(rng.choice(hay, 700), 13))
    elif name == "duplicates":
        hay = keys(0, 1000, 300)
        probes = np.sort(rng.choice(hay, 10_000))
    elif name == "outside":          # below and above every key
        hay = keys(1000, 2000, 500)
        probes = np.sort(np.concatenate([rng.integers(-5000, 1000, 3000),
                                         rng.choice(hay, 3000),
                                         rng.integers(2000, 9000, 3000)]))
    elif name == "i64_edges":        # keys near -2^62 and 2^62
        e = 1 << 62
        hay = np.unique(np.concatenate([rng.integers(-e, -e + 5000, 3000),
                                        rng.integers(e - 5000, e, 3000)]))
        probes = np.concatenate([rng.choice(hay, 4000),
                                 rng.integers(-e - 10, -e + 6000, 2000),
                                 rng.integers(e - 6000, e + 10, 2000)])
        probes = np.sort(probes)
    elif name == "many_blocks":      # 49 sorted blocks: windows found
        hay = keys(0, 1 << 33, 60_000)   # by a pass of their own
        probes = np.sort(np.concatenate([rng.choice(hay, 50_000),
                                         hay[:3], hay[-3:],
                                         rng.integers(-9, 1 << 33, 50_000)]))
    elif name == "empty_hay":
        hay = np.zeros(0, np.int64)
        probes = rng.integers(-10, 10, 5000)
    elif name == "unsorted_runs":    # blocks of sorted runs, not sorted
        hay = keys(0, 1 << 35, 500_000)
        runs = [np.sort(rng.choice(hay, 900)) for _ in range(12)]
        probes = np.concatenate(runs)
    elif name == "unsorted_small":   # the whole haystack is the sample
        hay = keys(0, 10_000, 3000)
        probes = rng.integers(-5, 10_005, 7000)
    else:                            # unsorted into a large haystack
        hay = keys(0, 1 << 45, 5_000_000)
        probes = np.where(rng.random(9000) < 0.5, rng.choice(hay, 9000),
                          rng.integers(0, 1 << 45, 9000))
    return t(hay), t(probes)


SEARCH_CASES = ["wide_window", "chunked_window", "straddle", "duplicates",
                "outside", "i64_edges", "many_blocks", "empty_hay",
                "unsorted_runs", "unsorted_small", "unsorted_large"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", SEARCH_CASES)
def test_search_matches_plain_on_card(cuda_device, name):
    rng = np.random.default_rng(SEARCH_CASES.index(name))
    hay, probes = _search_case(name, rng, cuda_device)
    before = search.launches
    got = search(hay, probes)
    torch.cuda.synchronize()
    assert search.launches == before + 1
    assert torch.equal(got, search_plain(hay, probes))


@pytest.mark.cuda
def test_search_haystack_past_2_31_on_card(cuda_device):
    """2^31 + 2^20 keys (17.2 GB of int64, on an 80 GB card): positions
    past 2^31, found by sorted and unsorted blocks alike."""
    m = (1 << 31) + (1 << 20)
    if torch.cuda.get_device_properties(0).total_memory < 3 * 8 * m:
        pytest.skip("needs about 52 GB of device memory")
    hay = torch.arange(m, device=cuda_device, dtype=torch.int64) * 3
    gen = torch.Generator(cuda_device).manual_seed(0)
    idx = torch.randint(0, m, (1 << 16,), generator=gen, device=cuda_device)
    probes = hay[idx] + torch.randint(0, 2, idx.shape, generator=gen,
                                      device=cuda_device)
    for p in (probes, torch.sort(probes).values,
              torch.tensor([0, 3 * (m - 1), 3 * (m - 1) + 1, -3],
                           device=cuda_device)):
        got = search(hay, p)
        want = torch.where(p % 3 == 0, p // 3, -1)
        want = torch.where((p >= 0) & (p < 3 * m), want, -1)
        assert torch.equal(got, want)
        assert int(got.max()) >= 1 << 31



def _offsets(rows, device):
    return torch.tensor(np.cumsum([0] + [len(r) for r in rows]),
                        dtype=torch.int64, device=device)


def _assert_merges_equal(rows, device):
    """``merge_path`` on the first two rows and ``multi_merge_ranks`` on
    all of them equal their plain versions, one launch each."""
    ts = [torch.from_numpy(r).to(device) for r in rows]
    before = (merge_path.launches, multi_merge_ranks.launches)
    got, want = merge_path(ts[0], ts[1]), merge_path_plain(ts[0], ts[1])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    keys, offs = torch.cat(ts), _offsets(rows, device)
    assert torch.equal(multi_merge_ranks(keys, offs),
                       multi_merge_ranks_plain(keys, offs))
    torch.cuda.synchronize()
    launched = (len(ts[0]) + len(ts[1]) > 0, len(keys) > 0)
    assert (merge_path.launches, multi_merge_ranks.launches) == \
        tuple(b + int(x) for b, x in zip(before, launched))


#: the longest row: one key, two, a tile (512 outputs, 1,024 ranks) or
#: so, many tiles, the main path's rows (about 6,250 keys) and beyond
MERGE_N_MAX = [1, 2, 300, 1500, 6250, 40_000]


@pytest.mark.cuda
@pytest.mark.parametrize("domain", sorted(MERGE_DOMAINS))
@pytest.mark.parametrize("n_max", MERGE_N_MAX)
def test_merges_on_adversarial_rows_on_card(cuda_device, domain, n_max):
    """``test_torch_merge_tiling``'s generator: empty, one-key, short,
    long and run-length rows, keys repeated within and across rows,
    around INT32_MAX and 2^62; k from 3 to 8."""
    rng = np.random.default_rng(n_max)
    for k in (3, 4, 5, 8):
        _assert_merges_equal(merge_rows(rng, k, n_max, domain),
                             cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["main_path", "table", "dense_row",
                                  "many_rows", "equal_runs"])
def test_merges_at_named_sizes_on_card(cuda_device, name):
    """The main path's launches (6,250 + 6,250 keys; 3 x 6,250), the
    table case's rows (3 x 345,000), a row far denser than the others
    (the splitter sample), 40 rows (two steps of the block map) and runs
    of equal keys across every tile edge."""
    rng = np.random.default_rng(11)

    def row(n, hi=1 << 40):
        return np.sort(rng.integers(0, hi, n))

    if name in ("main_path", "table"):
        n = 6250 if name == "main_path" else 345_000
        rows = [row(n) for _ in range(3)]
        rows[1] = np.sort(np.concatenate([rows[1][:-n // 4],
                                          rows[0][::4][:n // 4]]))
        rows[2] = np.sort(np.concatenate([rows[2][:-n // 5],
                                          rows[0][::5][:n // 5]]))
    elif name == "dense_row":
        dense = row(300_000, 1 << 24)
        rows = [np.sort(np.concatenate([dense[[0, 9, -1]], row(50, 1 << 24)])),
                dense, row(2000, 1 << 24), dense[:7].copy()]
    elif name == "many_rows":
        rows = [row(int(rng.integers(0, 900)), 5000) for _ in range(40)]
    else:
        vals = np.sort(rng.integers(0, 1 << 62, 6))
        rows = [np.repeat(vals, rng.integers(1, 1500, 6)) for _ in range(3)]
    _assert_merges_equal(rows, cuda_device)


@pytest.mark.cuda
def test_dense_smoke_prefill_on_card_launches_flash(cuda_device):
    import repro_torch.configs as C
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import api
    cfg = C.get_smoke("qwen2-7b")
    params = api.init(cfg, torch.Generator(cuda_device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 64), device=cuda_device)
    flash_attention.launches = 0
    logits = make_prefill_step(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert flash_attention.launches == cfg.n_layers
    assert logits.shape == (2, 64, 512)
    assert bool(torch.isfinite(logits[..., :cfg.vocab]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("algo,design", [("bfs", "graphdyns"),
                                         ("sssp", "ours")])
def test_graph_design_on_card_matches_plain(cuda_device, algo, design):
    """One BFS and one SSSP run of the Fig-13 study at 24^2 vertices on
    the kernels equal the same run on the plain versions on the card:
    outputs, counters, Report and iterations; the kernels launched."""
    from repro_torch.bench import fig13_vcp
    from repro_torch.core.vectorized import VectorBackend
    from repro_torch.kernels.backends import TorchKernels
    side = 24
    v = side * side
    _, weighted, g = next(x for x in fig13_vcp.graphs(side) if x[0] == algo)
    spec = fig13_vcp.designs(weighted, v)[design]
    runs = []
    for backend in (VectorBackend(device=cuda_device), VectorBackend(
            device=cuda_device, kernel_backend=TorchKernels(cuda_device))):
        for k in KERNELS:
            k.launches = 0
        ci = CollectingInstr()
        res, iters = fig13_vcp.run_vcp(spec, g, v, backend, extra_instr=ci)
        runs.append((res, ci, iters, {k.__name__: k.launches
                                      for k in KERNELS}))
    (rk, ck, ik, lk), (rp, cp, ip, lp) = runs
    assert lk["search"] > 0 and lk["merge_path"] > 0
    assert set(lp.values()) == {0}
    assert ik == ip
    assert rk.fallback_reasons == {} and rk.downgrade_events == {}
    for name in rp.tensors:
        assert list(rk[name].iter_leaves()) == list(rp[name].iter_leaves())
    for attr in ("touch_counts", "iter_counts", "compute_counts",
                 "isect_steps", "isect_matches", "advances", "merges"):
        assert getattr(ck, attr) == getattr(cp, attr), attr
    assert rk.report.seconds == rp.report.seconds


def _dse_sweep(device, **kw):
    from repro_torch.bench import dse_sweep
    from repro_torch.dse import DesignSpace, SweepEngine
    inputs, shapes = dse_sweep.workload(m=48, k=48, n=48)
    pts = DesignSpace("gamma", axes={
        "fibercache_mb": [0.002, 0.05, 1.0, 6.0]}).grid()
    eng = SweepEngine(inputs, shapes, backend="vector", device=device, **kw)
    return eng, [(r.label, r.seconds, r.energy_pj, r.dram_bytes,
                  r.fallback_reasons, r.error) for r in eng.sweep(pts)]


@pytest.mark.cuda
def test_vector_sweep_on_card_matches_cpu(cuda_device):
    """A vector-fidelity sweep on the card's kernels equals the same
    sweep on the CPU's plain versions, point for point, natively."""
    search.launches = 0
    _, card = _dse_sweep(cuda_device)
    assert search.launches > 0
    _, cpu = _dse_sweep("cpu")
    assert card == cpu
    assert all(r[4] == {} and r[5] is None for r in card)


@pytest.mark.cuda
def test_vector_sweep_process_pool_spawns_on_card(cuda_device):
    """The process executor of a card sweep spawns its workers (a forked
    child of a process that has initialised CUDA cannot use it) and
    equals the serial sweep."""
    eng, pooled = _dse_sweep(cuda_device, executor="process", max_workers=2)
    assert eng._start_method() == "spawn"
    _, serial = _dse_sweep(cuda_device)
    assert pooled == serial


@pytest.mark.cuda
def test_throughput_rowwise_on_card_matches_plain(cuda_device):
    """The throughput bench's rowwise SpMSpM at 1,024^2 (1%) on the hand
    kernels does the plain versions' work and builds their output, bit
    for bit (equal digests), launching ``search``."""
    from repro_torch.bench import backend_throughput as bt
    from repro_torch.kernels.backends import TorchKernels
    kern = bt.bench(sizes=[1024], backend="vector", mapped_sizes=[],
                    device=cuda_device, reps=1)
    plain = bt.bench(sizes=[1024], backend="vector", mapped_sizes=[],
                     device=cuda_device, reps=1,
                     kernel_backend=TorchKernels(cuda_device))
    assert kern[0]["lowering"] == "cuda" and plain[0]["lowering"] == "torch"
    assert kern[0]["launches"]["search"] > 0
    for key in ("elements", "out_nnz", "nnz_a", "nnz_b", "out_sha256"):
        assert kern[0][key] == plain[0][key], key
    # the reference's CPU record of the same workload
    assert (kern[0]["elements"], kern[0]["out_nnz"]) == (107485, 102174)


def _same(got, want):
    if isinstance(got, (tuple, list)):
        return len(got) == len(want) and all(map(_same, got, want))
    return got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.cuda
def test_seam_outputs_cuda_match_torch_on_card(cuda_device):
    """Every seam of the ``cuda`` lowering returns the ``torch``
    lowering's arrays on the seam bench's inputs."""
    from repro_torch.bench import kernels_bench
    n = 1 << 16
    cuda = kernels_bench.seam_outputs("cuda", cuda_device, n)
    plain = kernels_bench.seam_outputs("torch", cuda_device, n)
    assert set(cuda) == {"intersect", "union_k", "lookup",
                         "segmented_reduce"}
    for seam in cuda:
        assert _same(cuda[seam], plain[seam]), seam


#: Whisper-small's non-causal attention calls (b, h, hkv, sq, sk, d): the
#: encoder over 1,500 frames, cross-attention of a 448-token prefill, and
#: one decode query over the cached frames
WHISPER_CASES = [(4, 12, 12, 1500, 1500, 64), (4, 12, 12, 448, 1500, 64),
                 (4, 12, 12, 1, 1500, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WHISPER_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_attention_whisper_shapes_on_card(cuda_device, shape, dtype):
    q, k, v = _qkv(shape, dtype, cuda_device, seed=11)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(),
                               flash_attention_plain(q, k, v, False).float(),
                               rtol=0, atol=ATTN_ATOL[dtype])


#: one causal prefill layer (b, h, hkv, sq, sk, d) at batch 1:
#: Qwen2-MoE-A2.7B's 16 heads, the reduced Jamba's 32 over 8 KV heads
FAMILY_PREFILL_CASES = [(1, 16, 16, 2048, 2048, 128),
                        (1, 32, 8, 2048, 2048, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FAMILY_PREFILL_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_attention_family_prefill_shapes_on_card(cuda_device, shape,
                                                       dtype):
    q, k, v = _qkv(shape, dtype, cuda_device, seed=12)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(),
                               flash_attention_plain(q, k, v, True).float(),
                               rtol=0, atol=ATTN_ATOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_on_card_matches_cpu(cuda_device, arch, dtype):
    """One layer's dispatch at 2 x 64 tokens (16 groups, assignments
    dropped): routes equal to the CPU run's, outputs within fp32
    reassociation (2e-5) or bf16 rounding (6e-2, BF16_ATOL)."""
    import dataclasses
    import repro_torch.configs as C
    from repro_torch.models import moe
    cfg = dataclasses.replace(C.get_smoke(arch), dtype=dtype)
    gen = torch.Generator(cuda_device).manual_seed(3)
    layer = moe.MoELayer(cfg, gen, cuda_device)
    x = torch.randn((2, 64, cfg.d_model), generator=gen,
                    device=cuda_device).to(getattr(torch, dtype))
    host = moe.MoELayer(cfg, None, "cpu")
    host.load_state_dict(layer.state_dict())
    g, capacity = moe.dispatch_shape(cfg, 128)
    routes = [moe.route((xx.reshape(128, -1).float() @ p.router).reshape(
        g, -1, cfg.moe.n_experts), cfg.moe.top_k, capacity)
        for xx, p in ((x, layer), (x.cpu(), host))]
    for a, b in zip(routes[0][:3], routes[1][:3]):
        assert torch.equal(a.cpu(), b)
    assert not bool(routes[1][2].all())
    got, aux = moe.moe_ffn(cfg, layer, x)
    want, aux_host = moe.moe_ffn(cfg, host, x.cpu())
    atol = 2e-5 if dtype == "float32" else 6e-2
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=2e-5,
                               atol=atol)
    torch.testing.assert_close(aux.cpu(), aux_host, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "whisper-small",
                                  "jamba-1.5-large-398b"])
def test_family_smoke_prefill_on_card_launches_kernels(cuda_device, arch):
    """Qwen2-MoE one flash launch a layer; Whisper one an encoder layer
    and two a decoder layer; Jamba's superblock one flash and seven
    ``ssd_chunk``."""
    import repro_torch.configs as C
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import api
    cfg = C.get_smoke(arch)
    params = api.init(cfg, torch.Generator(cuda_device).manual_seed(0))
    batch = api.make_batch(cfg, torch.Generator(cuda_device).manual_seed(1),
                           2, 64)
    flash_attention.launches = ssd_chunk.launches = 0
    logits = make_prefill_step(cfg)(params, batch)
    torch.cuda.synchronize()
    want = {"moe": (cfg.n_layers, 0),
            "encdec": (cfg.enc_layers + 2 * cfg.n_layers, 0),
            "hybrid": (1, 7)}[cfg.family]
    assert (flash_attention.launches, ssd_chunk.launches) == want
    assert logits.shape == (2, 64, 512)
    assert bool(torch.isfinite(logits[..., :cfg.vocab]).all())


# ---------------------------------------------------------------------- #
# the training path: the flash backward kernel, lse, ssd_chunk under grad
# ---------------------------------------------------------------------- #
#: (b, h, hkv, sq, sk, d): GQA, sq != sk with ragged tails, each d
BWD_CASES = [(1, 2, 2, 64, 64, 32), (2, 4, 2, 100, 150, 64),
             (1, 2, 1, 130, 70, 128), (1, 3, 3, 77, 1500, 64),
             (2, 4, 4, 256, 256, 128)]


def _bwd_inputs(shape, dtype, device, seed=0):
    b, h, hkv, sq, sk, d = shape
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device).to(dtype)
            for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                      (b, h, sq, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", BWD_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_attention_bwd_matches_plain_on_card(cuda_device, shape,
                                                   dtype, causal):
    from repro_torch.kernels import (flash_attention_bwd,
                                     flash_attention_bwd_plain,
                                     flash_attention_lse_plain)
    from repro_torch.kernels.flash_attention import _launch
    from repro_torch.kernels.flash_attention_bwd import (
        ATOL, bwd_err, flash_attention_bwd_scale)
    q, k, v, do = _bwd_inputs(shape, dtype, cuda_device)
    o, lse, _ = _launch(q, k, v, causal, with_lse=True)
    # the forward's lse: the plain version's within fp32 rounding
    torch.testing.assert_close(lse, flash_attention_lse_plain(q, k, v,
                                                              causal),
                               rtol=1e-6, atol=1e-5)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    assert all(g.dtype == dtype for g in got)
    scale = flash_attention_bwd_scale(q, k, v, o, lse, do, causal)
    assert bwd_err(got, want, scale) <= ATOL[dtype]
    # two passes, no atomics: the same bits again
    again = flash_attention_bwd(q, k, v, o, lse, do, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _bwd_hold(q, k, v, do, causal):
    """The backward kernel on the forward kernel's o and lse, held to the
    plain backward by ``bwd_err`` within ATOL, and called twice: the
    kernel's gradients and whether the two calls gave the same bits."""
    from repro_torch.kernels import (flash_attention_bwd,
                                     flash_attention_bwd_plain)
    from repro_torch.kernels.flash_attention import _launch
    from repro_torch.kernels.flash_attention_bwd import (
        ATOL, bwd_err, flash_attention_bwd_scale)
    o, lse, _ = _launch(q, k, v, causal, with_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    scale = flash_attention_bwd_scale(q, k, v, o, lse, do, causal)
    err = bwd_err(got, want, scale)
    assert err <= ATOL[q.dtype], err
    return got, all(torch.equal(a, b) for a, b in zip(got, again))


#: (b, h, hkv, sq, sk, d), causal: the bf16 kernel's edges -- causal with
#: sq < sk and sq > sk (the mask top-left aligned), ragged key tails at
#: 129, 255 and 1,500 keys (one past a 128-key block, one short of two,
#: Whisper's frames), GQA at 7:1, each head dim
BWD_EDGES = [((1, 2, 2, 100, 300, 64), True),
             ((1, 2, 2, 300, 100, 128), True),
             ((1, 2, 1, 70, 129, 128), False),
             ((2, 2, 2, 255, 255, 64), True),
             ((1, 2, 2, 200, 1500, 32), False),
             ((1, 14, 2, 256, 256, 128), True),
             ((2, 3, 3, 130, 130, 32), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", BWD_EDGES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_attention_bwd_edges_on_card(cuda_device, shape, causal,
                                           dtype):
    """Held to the plain backward within ATOL, and two calls bit-equal."""
    q, k, v, do = _bwd_inputs(shape, dtype, cuda_device, seed=5)
    got, same = _bwd_hold(q, k, v, do, causal)
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    assert same


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_attention_bwd_strided_views_on_card(cuda_device, d, dtype):
    """[b, s, h, d] tensors read through [b, h, s, d] views in place (the
    model's layout); the gradients come back in that layout."""
    g = torch.Generator(cuda_device).manual_seed(6)
    b, s, h, hkv = 2, 190, 4, 2
    q, do = (torch.randn(b, s, h, d, generator=g, device=cuda_device)
             .to(dtype).transpose(1, 2) for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, generator=g, device=cuda_device)
            .to(dtype).transpose(1, 2) for _ in range(2))
    got, same = _bwd_hold(q, k, v, do, True)
    assert same
    assert got[0].stride() == q.stride() and got[1].stride() == k.stride()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_attention_bwd_empty_batch_on_card(cuda_device, dtype):
    """A batch of 0 gives empty gradients and launches nothing that fails;
    no queries gives zero dk and dv."""
    from repro_torch.kernels import flash_attention_bwd
    q, k, v, do = _bwd_inputs((0, 2, 2, 64, 64, 64), dtype, cuda_device)
    lse = torch.zeros(0, 2, 64, device=cuda_device)
    got = flash_attention_bwd(q, k, v, q, lse, do)
    torch.cuda.synchronize()
    assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
    q, k, v, do = _bwd_inputs((1, 2, 2, 0, 64, 64), dtype, cuda_device)
    lse = torch.zeros(1, 2, 0, device=cuda_device)
    dq, dk, dv = flash_attention_bwd(q, k, v, q, lse, do, False)
    torch.cuda.synchronize()
    assert dq.shape == q.shape
    assert not bool(dk.any()) and not bool(dv.any())


@pytest.mark.cuda
def test_flash_attention_under_autograd_on_card(cuda_device):
    """Inputs that require a gradient take ``FlashAttention``: an output
    with a ``grad_fn``, one forward and one backward launch, gradients of
    the strided [b, s, h, d] views the model passes equal to the plain
    backward's."""
    from repro_torch.kernels import (flash_attention_bwd,
                                     flash_attention_bwd_plain,
                                     flash_attention_lse_plain)
    from repro_torch.kernels.flash_attention_bwd import (
        ATOL, bwd_err, flash_attention_bwd_scale)
    g = torch.Generator(cuda_device).manual_seed(3)
    base = [torch.randn(2, 96, n, 64, generator=g, device=cuda_device)
            .to(torch.bfloat16).requires_grad_() for n in (4, 2, 2)]
    q, k, v = (t.transpose(1, 2) for t in base)
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    o = flash_attention(q, k, v)
    assert o.grad_fn is not None
    do = torch.randn(o.shape, generator=g, device=cuda_device).to(o.dtype)
    o.backward(do)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == \
        (f0 + 1, b0 + 1)
    with torch.no_grad():
        lse = flash_attention_lse_plain(q, k, v)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do)
        scale = flash_attention_bwd_scale(q, k, v, o, lse, do)
    got = [t.grad.transpose(1, 2) for t in base]
    assert bwd_err(got, want, scale) <= ATOL[torch.bfloat16]
    # without autograd nothing more is written and no graph is built
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None


@pytest.mark.cuda
def test_flash_attention_bwd_rejects_an_unsupported_head_dim(cuda_device):
    from repro_torch.kernels import flash_attention_bwd
    q = torch.randn(1, 1, 8, 48, device=cuda_device)
    lse = torch.zeros(1, 1, 8, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(q, q, q, q, lse, q)


def _ssd_grad_inputs(shape, dtype, device, seed, strong=False):
    B, nc, l, H, P, N = shape
    g = torch.Generator(device).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, device=device)
    a = -5 * torch.rand(B, H, nc, l, generator=g, device=device) if strong \
        else -randn(B, H, nc, l).abs() * 0.1
    return (randn(B, nc, l, H, P).to(dtype), a, randn(B, nc, l, N).to(dtype),
            randn(B, nc, l, N).to(dtype), randn(B, nc, l, H, P))


#: the SSD backward's card cases: the production chunk; off its 64-row
#: tiles, the ragged case (N and P off 16); the longest chunk (l 512: dG's
#: tiles in scratch); five heads, which split into head groups of 2, 2
#: and 1 (``ssd_chunk_bwd.head_group``)
SSD_GRAD_CASES = [(1, 2, 256, 8, 64, 128), (2, 1, 100, 3, 24, 40),
                  (1, 2, 512, 4, 64, 32), (4, 8, 256, 5, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_GRAD_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_ssd_chunk_grad_on_card_matches_plain(cuda_device, shape, dtype):
    """Inputs that require a gradient take ``SsdChunk``: one forward and
    one backward launch, and the gradients of every input within ATOL of
    the plain backward by ``bwd_err``."""
    from repro_torch.kernels import ssd_chunk_bwd, ssd_chunk_bwd_plain
    from repro_torch.kernels.ssd_chunk_bwd import (ATOL, bwd_err,
                                                   ssd_chunk_bwd_scale)
    x, a, b, c, dy = _ssd_grad_inputs(shape, dtype, cuda_device, 4)
    leaves = [t.clone().requires_grad_() for t in (x, a, b, c)]
    f0, b0 = ssd_chunk.launches, ssd_chunk_bwd.launches
    y = ssd_chunk(*leaves)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert (ssd_chunk.launches, ssd_chunk_bwd.launches) == (f0 + 1, b0 + 1)
    want = ssd_chunk_bwd_plain(x, a, b, c, dy)
    assert bwd_err(got, want, ssd_chunk_bwd_scale(x, a, b, c, dy)) <= ATOL
    with torch.no_grad():
        assert ssd_chunk(*leaves).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 512, 2, 32, 16)] + SSD_GRAD_CASES,
                         ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_ssd_chunk_bwd_bit_equal_on_card(cuda_device, shape, dtype):
    """No atomics: two calls on the same inputs give the same bits, under
    strong decay, at the longest chunk (l 512: dG's tiles in scratch) and
    with head groups of unequal size."""
    from repro_torch.kernels import ssd_chunk_bwd, ssd_chunk_bwd_plain
    from repro_torch.kernels.ssd_chunk_bwd import (ATOL, bwd_err,
                                                   ssd_chunk_bwd_scale)
    args = _ssd_grad_inputs(shape, dtype, cuda_device, 5, strong=True)
    got = ssd_chunk_bwd(*args)
    assert all(torch.equal(u, v) for u, v in zip(got, ssd_chunk_bwd(*args)))
    assert bwd_err(got, ssd_chunk_bwd_plain(*args),
                   ssd_chunk_bwd_scale(*args)) <= ATOL


@pytest.mark.cuda
def test_ssd_chunk_bwd_launch_split_on_card(cuda_device):
    """The timed entry gives the device ms of each of the five launches,
    positive and summing to no more than the call's wall time, and counts
    as one launch."""
    import time
    from repro_torch.kernels import ssd_chunk_bwd
    from repro_torch.kernels.ssd_chunk_bwd import (LAUNCHES,
                                                   ssd_chunk_bwd_launch_ms)
    args = _ssd_grad_inputs((2, 4, 256, 8, 64, 128), torch.bfloat16,
                            cuda_device, 6)
    ssd_chunk_bwd(*args)                  # built and warm
    torch.cuda.synchronize()
    b0 = ssd_chunk_bwd.launches
    t0 = time.perf_counter()
    ms = ssd_chunk_bwd_launch_ms(*args)
    wall = (time.perf_counter() - t0) * 1e3
    assert ssd_chunk_bwd.launches == b0 + 1
    assert tuple(ms) == LAUNCHES and all(v > 0 for v in ms.values())
    assert sum(ms.values()) <= wall


@pytest.mark.cuda
def test_mamba2_smoke_train_step_on_card(cuda_device):
    """Two train steps of the Mamba2 smoke config on the card: finite
    loss, one ``ssd_chunk``, one recomputed and one backward launch a
    layer a step, and the same loss as the step on the CPU to bf16
    rounding."""
    import repro_torch.configs as C
    from repro_torch.kernels import ssd_chunk_bwd
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api
    from repro_torch.optim import optimizers as opt
    cfg = C.get_smoke("mamba2-1.3b")
    batch = api.make_batch(cfg, torch.Generator().manual_seed(1), 2, 64)
    losses = {}
    for dev in (torch.device("cpu"), cuda_device):
        params = api.init(cfg, torch.Generator().manual_seed(0)).to(dev)
        o = opt.adamw(1e-3)
        state = o.init(dict(params.named_parameters()))
        step = make_train_step(cfg, o, device=dev)
        f0, b0 = ssd_chunk.launches, ssd_chunk_bwd.launches
        for _ in range(2):
            params, state, m = step(params, state, batch)
        losses[dev.type] = float(m["loss"])
        if dev.type == "cuda":
            assert ssd_chunk.launches - f0 == 2 * 2 * cfg.n_layers
            assert ssd_chunk_bwd.launches - b0 == 2 * cfg.n_layers
    assert np.isfinite(losses["cuda"])
    assert abs(losses["cuda"] - losses["cpu"]) <= 2e-2


@pytest.mark.cuda
def test_olmo_smoke_train_step_on_card(cuda_device):
    """Two train steps of the OLMo smoke config on the card: finite loss,
    one flash forward, one recomputed forward and one backward a layer a
    step, and the same loss as the step on the CPU to bf16 attention
    rounding."""
    import repro_torch.configs as C
    from repro_torch.kernels import flash_attention_bwd
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api
    from repro_torch.optim import optimizers as opt
    cfg = C.get_smoke("olmo-1b")
    batch = api.make_batch(cfg, torch.Generator().manual_seed(1), 2, 64)
    losses = {}
    for dev in (torch.device("cpu"), cuda_device):
        params = api.init(cfg, torch.Generator().manual_seed(0)).to(dev)
        o = opt.adamw(1e-3)
        state = o.init(dict(params.named_parameters()))
        step = make_train_step(cfg, o, device=dev)
        f0, b0 = flash_attention.launches, flash_attention_bwd.launches
        for _ in range(2):
            params, state, m = step(params, state, batch)
        losses[dev.type] = float(m["loss"])
        if dev.type == "cuda":
            assert flash_attention.launches - f0 == 2 * 2 * cfg.n_layers
            assert flash_attention_bwd.launches - b0 == 2 * cfg.n_layers
    assert np.isfinite(losses["cuda"])
    assert abs(losses["cuda"] - losses["cpu"]) <= 2e-2


#: ((b, h, hkv, sq, sk, d), causal): the attention shapes of the MoE,
#: encoder-decoder and hybrid train steps at batch 1 -- Whisper's encoder
#: (1,500 frames, non-causal, a ragged last key tile) and decoder self-
#: attention (448 tokens, causal, ragged), the reduced Jamba's GQA
TRAIN_BWD_SHAPES = [((1, 12, 12, 1500, 1500, 64), False),
                    ((1, 12, 12, 448, 448, 64), True),
                    ((1, 32, 8, 2048, 2048, 128), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", TRAIN_BWD_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_attention_bwd_family_train_shapes_on_card(cuda_device, shape,
                                                         causal, dtype):
    q, k, v, do = _bwd_inputs(shape, dtype, cuda_device, seed=5)
    _, same = _bwd_hold(q, k, v, do, causal)
    assert same


@pytest.fixture
def chip_smoke():
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke as mod
        yield mod
    finally:
        sys.path.remove(root)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "whisper-small",
                                  "jamba-1.5-large-398b"])
def test_family_smoke_train_step_on_card(cuda_device, chip_smoke, arch):
    """The smoke config's train step on the card through
    ``chip_smoke.phase_train_step`` (finite loss, ``train_launches`` a
    step, every kernel call in bf16, the routes of forward and
    recomputation) and its fp32 step held to the plain kernels with the
    routes replayed (``phase_train_consistency``: loss, every gradient,
    every kernel call)."""
    import repro_torch.configs as C
    cfg = C.get_smoke(arch)
    step = chip_smoke.phase_train_step(cuda_device, cfg, batch=2, seq=64,
                                       warmup=1, steps=2)
    assert step["launches"] == {n: 2 * c for n, c in
                                chip_smoke.train_launches(cfg).items()}
    cons = chip_smoke.phase_train_consistency(cuda_device, cfg,
                                              shape=(2, 64))
    assert cons["loss_rel"] <= chip_smoke.TRAIN_LOSS_RTOL
    assert cons["grad_rel"] <= chip_smoke.TRAIN_GRAD_TOL
    assert cons["routes"] == 2 * chip_smoke.moe_layers(cfg)
