"""The gradient of ``ssd_chunk`` on the CPU: the plain backward against
the reference's ``jax.vjp``, the autograd Function against autograd
through the plain forward, and the backward kernel's arithmetic emulated.

``ssd_chunk_bwd_plain`` is the closed form of the gradient; the reference
has no backward kernel, so it is held to ``jax.vjp`` of
``repro.kernels.ref.ssd_chunk_ref`` (fp32 on the reference's test shapes,
a strong-decay case, several seeds) by ``bwd_err``: each gradient
element's error over the summed magnitude of its terms
(``ssd_chunk_bwd_scale``).  The two differ in how they take the decay:
the reference sums each segment (``_segsum``), the plain version takes a
difference of cumulative sums rounded to fp32 (as the kernels do), which
moves L by ulps of |cum|; under strong decay (|cum| in the hundreds) that
is a few 1e-5 of a term, hence REF_TOL.

The kernel (``csrc/ssd_chunk_bwd.cu``) is emulated in torch: dW = dY X^T
on the bf16 tensor cores with dY split into two bf16 parts (and X, in
fp32, too), the other products on the TF32 tensor cores with hi/lo
splits (3xTF32 where both operands are fp32, 2 where one is bf16, exact
in TF32), ``__expf`` within its error bound, sums over row tiles, heads
(in head groups, ``head_group``) and column tiles in the kernel's order,
each row tile's dX, dB and dC products in a fresh accumulator, da's
reverse cumsum in fp64.  The emulation holds ATOL at the kernel's
tolerance; one TF32 rounding of dY misses it, and so does dY as one bf16
part in dW, and so does each planted fault: one head left out of dG (and
so of dB and dC), the last row tile left out of the column sums behind
da, the last row tile left out of dX.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_chunk_ref
from repro_torch.kernels import (SsdChunk, ssd_chunk, ssd_chunk_bwd,
                                 ssd_chunk_bwd_plain, ssd_chunk_plain)
from repro_torch.kernels.ssd_chunk_bwd import (ATOL, BF16_ROUNDING,
                                               bwd_err, head_group,
                                               ssd_chunk_bwd_launch_ms,
                                               ssd_chunk_bwd_scale)
from test_torch_bsmm_numerics import split
from test_torch_ssd_numerics import _decay as decay_expf
from test_torch_ssd_numerics import _split as _bf16_split

#: the reference's SSD_SHAPES (tests/test_kernels.py), then one off the
#: kernel's 64-row tiles with N and P off 16 (the card tests' ragged case)
SHAPES = [(1, 2, 64, 2, 32, 16), (2, 3, 128, 4, 64, 32),
          (1, 1, 256, 8, 64, 128), (2, 1, 100, 3, 24, 40)]
#: plain backward vs jax.vjp of the reference: the decay's two forms (see
#: the module docstring); mild decay reads about 1e-7
REF_TOL = 1e-4
#: the kernel's tiles (csrc/ssd_chunk_bwd.cu's kT)
TILE = 64


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_exp():
    """The first large multithreaded ``torch.exp`` of a process can come
    back about 1e-4 off (tests/test_torch_ssm.py): spend it here."""
    torch.exp(torch.rand(1 << 22))


def _inputs(shape, seed=3, strong=False, dtype=torch.float32):
    """Seeded numpy inputs as the reference's tests make them: standard
    normal x, b, c and dy; a = -0.1 |normal|, or uniform in (-5, 0] for
    strong decay."""
    B, nc, l, H, P, N = shape
    rng = np.random.default_rng(seed)

    def normal(*s):
        return rng.standard_normal(s).astype(np.float32)

    x = normal(B, nc, l, H, P)
    a = (-5 * rng.random((B, H, nc, l))).astype(np.float32) if strong \
        else (-np.abs(normal(B, H, nc, l)) * 0.1).astype(np.float32)
    b, c, dy = normal(B, nc, l, N), normal(B, nc, l, N), \
        normal(B, nc, l, H, P)
    t = [torch.from_numpy(v) for v in (x, a, b, c, dy)]
    for i in (0, 2, 3):
        t[i] = t[i].to(dtype)
    return t


def _jax_vjp(x, a, b, c, dy):
    args = [jnp.asarray(t.float().numpy()) for t in (x, a, b, c)]
    _, vjp = jax.vjp(ssd_chunk_ref, *args)
    return [torch.from_numpy(np.array(g)) for g in
            vjp(jnp.asarray(dy.numpy()))]


# ---------------------------------------------------------------------- #
# the plain backward against the reference
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong"])
@pytest.mark.parametrize("seed", [3, 4, 5])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_jax_vjp(shape, seed, strong):
    x, a, b, c, dy = _inputs(shape, seed, strong)
    got = ssd_chunk_bwd_plain(x, a, b, c, dy)
    want = _jax_vjp(x, a, b, c, dy)
    scale = ssd_chunk_bwd_scale(x, a, b, c, dy)
    err = bwd_err(got, want, scale)
    assert err <= REF_TOL, err
    assert err <= 1e-6 or strong, err


# ---------------------------------------------------------------------- #
# the autograd Function on the CPU
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_function_matches_autograd_through_plain(shape, strong, dtype):
    """``ssd_chunk`` under autograd is ``SsdChunk`` (an output with its
    ``grad_fn``), whose gradient equals autograd through
    ``ssd_chunk_plain``: dx, db and dc the same bits (the same einsums),
    da within fp32 reassociation of its row and column sums."""
    x, a, b, c, dy = _inputs(shape, 6, strong, dtype)
    leaves = [t.clone().requires_grad_() for t in (x, a, b, c)]
    y = ssd_chunk(*leaves)
    assert y.grad_fn is not None and "SsdChunk" in type(y.grad_fn).__name__
    got = torch.autograd.grad(y, leaves, dy)
    leaves = [t.clone().requires_grad_() for t in (x, a, b, c)]
    want = torch.autograd.grad(ssd_chunk_plain(*leaves), leaves, dy)
    assert bwd_err(got, want, ssd_chunk_bwd_scale(x, a, b, c, dy)) <= 1e-6
    for i in (0, 2, 3):
        assert got[i].dtype == dtype and torch.equal(got[i], want[i])
    # without autograd the plain forward, and no graph
    with torch.no_grad():
        assert torch.equal(ssd_chunk(*leaves), ssd_chunk_plain(x, a, b, c))
        assert ssd_chunk(*leaves).grad_fn is None


def test_function_saves_inputs_not_output():
    x, a, b, c, dy = _inputs(SHAPES[0])
    leaves = [t.clone().requires_grad_() for t in (x, a, b, c)]
    y = SsdChunk.apply(*leaves)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 4
    assert all(s.data_ptr() == t.data_ptr() for s, t in zip(saved, leaves))


def test_bwd_wrapper_on_cpu_takes_plain_and_checks_inputs():
    x, a, b, c, dy = _inputs(SHAPES[0])
    ssd_chunk_bwd.launches = 0
    got = ssd_chunk_bwd(x, a, b, c, dy)
    assert ssd_chunk_bwd.launches == 0
    want = ssd_chunk_bwd_plain(x, a, b, c, dy)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="dy must be float32"):
        ssd_chunk_bwd(x, a, b, c, dy.bfloat16())
    with pytest.raises(ValueError, match="dy must be float32"):
        ssd_chunk_bwd(x, a, b, c, dy[:, :1])
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk_bwd(x, a, b, c, dy.transpose(3, 4).contiguous()
                      .transpose(3, 4))
    with pytest.raises(ValueError, match="shapes disagree"):
        ssd_chunk_bwd(x, a[:, :1], b, c, dy)
    with pytest.raises(ValueError, match="share float32 or bfloat16"):
        ssd_chunk_bwd(x, a, b.bfloat16(), c, dy)
    # the meta device (a dry run's route): empty gradients of the
    # inputs' shapes and dtypes, no launch and no plain version
    grads = ssd_chunk_bwd(*(t.to("meta") for t in (x, a, b, c, dy)))
    assert [(g.device.type, g.shape, g.dtype) for g in grads] == \
        [("meta", t.shape, t.dtype) for t in (x, a, b, c)]
    assert ssd_chunk_bwd.launches == 0


def test_launch_split_needs_a_card():
    """The per-launch timing is a measurement of the kernel: on CPU
    tensors there is none to time, and it says so."""
    x, a, b, c, dy = _inputs(SHAPES[0])
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        ssd_chunk_bwd_launch_ms(x, a, b, c, dy)


# ---------------------------------------------------------------------- #
# the error measure
# ---------------------------------------------------------------------- #
def test_bwd_err_measure():
    """0 on equal gradients; inf on a wrong dtype, a NaN, or a nonzero
    error where every term is zero; a bf16 gradient one rounding apart is
    no error, two are; an fp32 error is its share of the element's
    scale."""
    x, a, b, c, dy = _inputs(SHAPES[0], dtype=torch.bfloat16)
    want = list(ssd_chunk_bwd_plain(x, a, b, c, dy))
    scale = ssd_chunk_bwd_scale(x, a, b, c, dy)
    assert bwd_err(want, want, scale) == 0.0
    assert bwd_err([w.float() for w in want], want, scale) == math.inf
    bad = [w.clone() for w in want]
    bad[1][0, 0, 0, 5] = float("nan")
    assert bwd_err(bad, want, scale) == math.inf
    zero = [torch.zeros_like(w) for w in want]
    zs = [torch.zeros_like(s) for s in scale]
    assert bwd_err(zero, zero, zs) == 0.0
    assert bwd_err(want, zero, zs) == math.inf
    # dx one bf16 ulp up: taken out; 2^-6 of the value: not
    dx = want[0].float()
    up = torch.nextafter(want[0], torch.full_like(want[0], math.inf))
    assert bwd_err([up] + want[1:], want, scale) == 0.0
    far = (dx * (1 + 2.0 ** -5)).bfloat16()
    assert bwd_err([far] + want[1:], want, scale) > 100 * ATOL
    # da (fp32): an error of 1e-3 of one element's scale reads 1e-3
    da = want[1].clone()
    k = (0, 0, 0, 9)
    da[k] += 1e-3 * scale[1][k]
    err = bwd_err([want[0], da] + want[2:], want, scale)
    assert err == pytest.approx(1e-3, rel=1e-3)
    assert BF16_ROUNDING > 2.0 ** -7


# ---------------------------------------------------------------------- #
# the kernel's arithmetic, emulated
# ---------------------------------------------------------------------- #
def _tf32_mm(u, w, u_lo, w_lo):
    """u @ w on the TF32 tensor cores: an operand with a lo part (fp32)
    goes as hi + lo, one without (bf16, exact in TF32) as it is; terms
    al bh, ah bl, ah bh in fp32."""
    uh, ul = split(u)
    wh, wl = split(w)
    out = uh @ wh
    if u_lo:
        out = ul @ wh + out
    if w_lo:
        out = uh @ wl + out
    return out


def _bf16_parts_mm(u, w, parts, w_parts=1):
    """u @ w on the bf16 tensor cores with u (fp32) split into ``parts``
    bf16 terms and w into ``w_parts`` (1: w is bf16, exact): each term's
    product exact in fp32, the products of combined order below two
    parts kept (u_lo w_hi, u_hi w_lo), summed small terms first, as the
    kernel takes dW = dY X^T."""
    us, ws = _bf16_split(u, parts), _bf16_split(w, w_parts)
    terms = [(a, b) for a in range(parts) for b in range(w_parts)
             if a + b < max(parts, w_parts)]
    terms.sort(key=lambda ab: (-(ab[0] + ab[1]), -ab[0]))
    out = us[terms[0][0]] @ ws[terms[0][1]]
    for a, b in terms[1:]:
        out = out + us[a] @ ws[b]
    return out


def emulate(x, a, b, c, dy, fault=None, dy_lo=True, dy_parts=2, seed=0):
    """(dx, da, db, dc) as ``csrc/ssd_chunk_bwd.cu`` computes them: G =
    C B^T (one pass in bf16, 3xTF32 in fp32); L as ``__expf`` takes it
    (``test_torch_ssd_numerics._decay``); per head and row tile it, dW =
    dY X^T with dY split into ``dy_parts`` bf16 terms (bf16: X exact;
    fp32: X split into two bf16 terms, three products), W = G L, M = dW W;
    dG summed over the heads of each head group in order, then over the
    groups in order (``head_group``); M's column sums over 16-row groups
    then row tiles in order, its row sums a 32-column half of a column
    tile each, added over column tiles and halves in order; dX as the two
    consumers' sums over their 32 rows i of each row tile (3xTF32, a
    tile's product fresh), added; dB over row tiles and dC over column
    tiles, a tile's product fresh (dG split, B and C split in fp32); da
    the fp64 reverse cumsum.  ``fault``: ``"drop_head"`` leaves the last
    head out of dG, ``"drop_colsum_tile"`` the last row tile out of the
    column sums, ``"drop_dx_tile"`` the last row tile out of dX;
    ``dy_lo`` False rounds dY once to TF32 in every product."""
    B, nc, l, H, P = x.shape
    lo = x.dtype == torch.float32
    n_rt = -(-l // TILE)
    xf, bf, cf = x.float(), b.float(), c.float()
    L = decay_expf(a, seed)                                    # [B,H,nc,l,s]
    G = _tf32_mm(cf, bf.transpose(-1, -2), lo, lo)             # [B,nc,l,s]
    W = G[:, None] * L
    dyh = dy.permute(0, 3, 1, 2, 4)                            # [B,H,nc,l,P]
    if not dy_lo:
        dyh = split(dyh)[0]
    xh = xf.permute(0, 3, 1, 2, 4)
    if not dy_lo:
        dW = _tf32_mm(dyh, xh.transpose(-1, -2), False, lo)    # [B,H,nc,l,s]
    else:
        dW = _bf16_parts_mm(dyh, xh.transpose(-1, -2), dy_parts,
                            2 if lo else 1)
    M = dW * W
    dG = torch.zeros_like(G)
    hg = head_group(B, nc, l, H)
    for h0 in range(0, H, hg):
        part = torch.zeros_like(G)
        for h in range(h0, min(h0 + hg, H - (fault == "drop_head"))):
            part = part + dW[:, h] * L[:, h]
        dG = dG + part
    halves = [torch.zeros_like(xh), torch.zeros_like(xh)]
    col = torch.zeros(B, H, nc, l)
    for it in range(n_rt):
        r = slice(it * TILE, (it + 1) * TILE)
        if fault != "drop_dx_tile" or it < n_rt - 1:
            for w in range(2):
                rw = slice(it * TILE + 32 * w, it * TILE + 32 * (w + 1))
                halves[w] = halves[w] + _tf32_mm(
                    dyh[..., rw, :].transpose(-1, -2), W[..., rw, :], dy_lo,
                    True).transpose(-1, -2)
        if fault != "drop_colsum_tile" or it < n_rt - 1:
            groups = [M[..., g0:min(g0 + 16, r.stop), :].sum(-2)
                      for g0 in range(r.start, min(r.stop, l), 16)]
            col = col + sum(groups[1:], groups[0])
    dx = halves[0] + halves[1]
    dcum = torch.zeros(B, H, nc, l)
    dc = torch.zeros(B, nc, l, b.shape[-1])
    for jt in range(n_rt):
        cj = slice(jt * TILE, (jt + 1) * TILE)
        for h0 in range(cj.start, min(cj.stop, l), 32):
            half = slice(h0, min(h0 + 32, l))
            share = M[..., half].sum(-1)
            share[..., half] -= col[..., half]
            share[..., :cj.start] = 0.0      # rows i < j: no share
            dcum = dcum + share
        dc = dc + _tf32_mm(dG[..., cj], bf[:, :, cj], True, lo)
    da = dcum.double().flip(-1).cumsum(-1).flip(-1).float()
    db = torch.zeros_like(bf)
    for jt in range(n_rt):
        cj = slice(jt * TILE, (jt + 1) * TILE)
        acc = torch.zeros_like(bf[:, :, cj])
        for it in range(jt, n_rt):
            r = slice(it * TILE, (it + 1) * TILE)
            acc = acc + _tf32_mm(dG[:, :, r, cj].transpose(-1, -2),
                                 cf[:, :, r], True, lo)
        db[:, :, cj] = acc
    return (dx.permute(0, 2, 3, 1, 4).to(x.dtype), da, db.to(b.dtype),
            dc.to(c.dtype))


#: the emulation's cases: the reference's production chunk shape, the
#: ragged one, strong decay at l 256
EMU_CASES = [(SHAPES[2], False), (SHAPES[3], False), (SHAPES[2], True)]
#: the planted faults the card's hold must catch (chip_smoke's
#: SSD_BWD_FAULTS plant the same on the card)
FAULTS = ["drop_head", "drop_colsum_tile", "drop_dx_tile"]


def _case(shape, strong, dtype, seed=3):
    x, a, b, c, dy = _inputs(shape, seed, strong, dtype)
    return (x, a, b, c, dy), ssd_chunk_bwd_plain(x, a, b, c, dy), \
        ssd_chunk_bwd_scale(x, a, b, c, dy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,strong", EMU_CASES, ids=str)
def test_kernel_arithmetic_within_atol(shape, strong, dtype):
    """The kernel's splits, ``__expf`` and sum orders stay well inside
    ATOL at two seeds; the measure sees them (not 0)."""
    for seed in (3, 4):
        args, want, scale = _case(shape, strong, dtype, seed)
        err = bwd_err(emulate(*args, seed=seed), want, scale)
        assert 0.0 < err <= ATOL / 4, (seed, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,strong", EMU_CASES[:2], ids=str)
def test_one_tf32_rounding_of_dy_misses_atol(shape, strong, dtype):
    """dY is fp32 in both dtypes: rounded once to TF32 (2^-11) in dW and
    dX it misses ATOL, which is why both products split it."""
    args, want, scale = _case(shape, strong, dtype)
    assert bwd_err(emulate(*args, dy_lo=False), want, scale) > 2 * ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,strong", EMU_CASES[:2], ids=str)
def test_one_bf16_part_of_dy_misses_atol_two_hold_it(shape, strong, dtype):
    """dW = dY X^T takes dY (fp32) as bf16 parts: one part (8 significant
    bits) misses ATOL, the kernel's two (16 bits) hold it four times
    inside (bf16 reads about 2e-7, fp32, where X is split too, 2e-6), so
    a third part would buy nothing the hold can see."""
    args, want, scale = _case(shape, strong, dtype)
    assert bwd_err(emulate(*args, dy_parts=1), want, scale) > 2 * ATOL
    assert bwd_err(emulate(*args, dy_parts=2), want, scale) <= ATOL / 4


@pytest.mark.parametrize("shape,hg", [
    ((8, 8, 256, 64, 64, 128), 32), ((4, 8, 256, 128, 64, 128), 32),
    ((4, 8, 256, 5, 64, 128), 2), ((1, 2, 512, 4, 64, 32), 1),
    ((2, 1, 100, 3, 24, 40), 1), ((1, 1, 64, 0, 64, 16), 1)])
def test_head_groups(shape, hg):
    """The main pass's items at the train shapes: Mamba2-1.3B's 64 cells
    of 64 heads and the reduced Jamba's 32 cells of 128 heads both split
    into 512 items of 32 heads; five heads over 128 (cell, column tile)
    pairs into groups of 2, 2 and 1 (the last group short)."""
    B, nc, l, H, _, _ = shape
    assert head_group(B, nc, l, H) == hg
    if H:
        groups = -(-H // hg)
        assert (groups - 1) * hg < H <= groups * hg


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,strong", EMU_CASES, ids=str)
def test_planted_faults_fail_the_hold(shape, strong, dtype, fault):
    args, want, scale = _case(shape, strong, dtype)
    assert bwd_err(emulate(*args, fault=fault), want, scale) > 10 * ATOL

