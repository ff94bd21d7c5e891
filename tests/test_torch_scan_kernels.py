"""The port's scan kernels (RWKV6 WKV, Mamba2 SSD) against the reference's
Pallas kernels, and the Hopper kernels' tiling modelled in torch.

CPU arms:

- the port's plain versions (``repro_torch.kernels.ref``, which the entry
  points use for CPU tensors) against the JAX Pallas kernels run as
  ``tests/test_kernels.py`` runs them (``interpret=True``), over that
  file's sweeps, on the same inputs made with numpy.  Tolerance: the
  reference sweep's 2e-4 absolute and relative (``test_kernels.py:96-180``):
  the step recurrence and the chunked scans sum in different orders;
- the checks of the device-independent entry points on CPU tensors;
- the arithmetic of each CUDA kernel written out in torch (its tiles and
  column split, the order of its prefix and suffix sums, the WKV kernel's
  16-row sub-blocks with the off-diagonal block as a product, the masked
  ragged last tile, the state it carries, and every product in split TF32:
  operands rounded to TF32 as hi and lo, hi·hi + hi·lo + lo·hi summed in
  f32), held against the recurrence at 2e-4, through it against the Pallas
  kernels, and across chunk, fold-tile or sub-tile sizes at the reference's
  1e-5 (RWKV6) and 1e-4 (Mamba2);
- why the kernels are built so: one TF32 pass of the products misses
  2e-4, and so does the TPU kernel's own fold at twice its 32-row tile.

The CUDA kernels themselves are held against the plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.mamba2_ssd import mamba2_ssd_fwd  # noqa: E402
from repro.kernels.rwkv6_scan import _fold_tile, rwkv6_wkv_fwd  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels.mamba2_ssd import STATE_ROWS, SUB_TILE, mamba2_ssd_cuda  # noqa: E402
from repro_torch.kernels.rwkv6_scan import FOLD_TILE, STATE_COLUMNS, SUB_BLOCK, \
    rwkv6_wkv_cuda  # noqa: E402

SCAN = dict(atol=2e-4, rtol=2e-4)

RWKV_SHAPES = [(1, 64, 2, 16), (2, 128, 3, 32), (1, 128, 1, 64)]
MAMBA_SHAPES = [(1, 64, 4, 16, 16), (2, 128, 8, 16, 24)]


def _softplus(x):
    return np.logaddexp(x, 0.0).astype(np.float32)


def _rwkv_inputs(b, s, h, dk, decay_strength, seed=10):
    rng = np.random.default_rng(seed)
    r, k, v, w = (rng.standard_normal((b, s, h, dk)).astype(np.float32) for _ in range(4))
    logw = -_softplus(w * decay_strength)
    u = rng.standard_normal((h, dk)).astype(np.float32)
    return r, k, v, logw, u


def _mamba_inputs(b, s, h, p, n, seed=20):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = _softplus(rng.standard_normal((b, s, h)).astype(np.float32))
    a = -np.exp(rng.standard_normal(h).astype(np.float32) * 0.2).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a, bm, cm


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ------------------------------------------------- CPU: plain vs Pallas ----
@pytest.mark.parametrize("b,s,h,dk", RWKV_SHAPES)
@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("decay_strength", [0.5, 6.0])
def test_rwkv6_ref_matches_pallas(b, s, h, dk, chunk, decay_strength):
    args = _rwkv_inputs(b, s, h, dk, decay_strength)
    want = rwkv6_wkv_fwd(*_j(*args), chunk=chunk, interpret=True)
    got = K.rwkv6_wkv(*_t(*args), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, dk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN)


def test_rwkv6_ref_strong_decay_is_finite():
    r, k, v, _, u = _rwkv_inputs(1, 64, 1, 16, 1.0, seed=15)
    logw = np.full_like(r, -25.0)               # decay ~ e^-25 per step
    want = rwkv6_wkv_fwd(*_j(r, k, v, logw, u), chunk=32, interpret=True)
    got = K.rwkv6_wkv(*_t(r, k, v, logw, u), chunk=32)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN)


@pytest.mark.parametrize("b,s,h,p,n", MAMBA_SHAPES)
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("head_block", [2, 4])
def test_mamba2_ref_matches_pallas(b, s, h, p, n, chunk, head_block):
    args = _mamba_inputs(b, s, h, p, n)
    want = mamba2_ssd_fwd(*_j(*args), chunk=chunk, head_block=head_block, interpret=True)
    got = K.mamba2_ssd(*_t(*args), chunk=chunk, head_block=head_block)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN)


# ------------------------------------------------- entry-point checks ----
@pytest.mark.parametrize("s,chunk,match", [
    (80, 40, "multiple"),      # above the fold tile and not a multiple of it
    (64, 48, "divisible"),     # the sequence does not divide into chunks
    (64, 0, "divisible"),
])
def test_rwkv6_rejects_degenerate_chunk_on_cpu(s, chunk, match):
    args = _t(*_rwkv_inputs(1, s, 1, 16, 1.0))
    with pytest.raises(ValueError, match=match):
        K.rwkv6_wkv(*args, chunk=chunk)
    if chunk == 40:            # the reference kernel rejects the same chunk
        with pytest.raises(ValueError, match=match):
            rwkv6_wkv_fwd(*_j(*_rwkv_inputs(1, s, 1, 16, 1.0)), chunk=chunk, interpret=True)


@pytest.mark.parametrize("chunk,head_block", [(24, 2), (16, 3)])
def test_mamba2_rejects_bad_chunk_or_head_block_on_cpu(chunk, head_block):
    args = _mamba_inputs(1, 64, 4, 8, 16)
    with pytest.raises(ValueError, match="hb="):
        K.mamba2_ssd(*_t(*args), chunk=chunk, head_block=head_block)
    with pytest.raises(ValueError, match="hb="):
        mamba2_ssd_fwd(*_j(*args), chunk=chunk, head_block=head_block, interpret=True)


def test_scan_entry_points_reject_mismatched_shapes():
    r, k, v, logw, u = _t(*_rwkv_inputs(1, 64, 2, 16, 1.0))
    with pytest.raises(ValueError):
        K.rwkv6_wkv(r, k, v, logw, u[:1], chunk=32)
    x, dt, a, bm, cm = _t(*_mamba_inputs(1, 64, 4, 8, 16))
    with pytest.raises(ValueError):
        K.mamba2_ssd(x, dt, a, bm, cm[:, :32], chunk=32, head_block=2)


def test_scan_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_wkv_cuda(*_t(*_rwkv_inputs(1, 64, 1, 16, 1.0)), chunk=32)
    with pytest.raises(ValueError, match="CUDA"):
        mamba2_ssd_cuda(*_t(*_mamba_inputs(1, 64, 4, 8, 16)), chunk=32, head_block=2)


def test_scan_cpu_dispatch_counts_no_launch():
    before = K.launch_counts()
    K.rwkv6_wkv(*_t(*_rwkv_inputs(1, 32, 1, 16, 1.0)), chunk=32)
    K.mamba2_ssd(*_t(*_mamba_inputs(1, 32, 2, 8, 16)), chunk=32, head_block=2)
    assert K.launch_counts() == before


# ------------------------------------------- the CUDA kernels' arithmetic ----
LOG2E = 1.4426950408889634


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), nearest-even."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def mm(a, b, passes=3):
    """a @ b with the operands as the kernels hand them to the tensor cores:
    3 = split TF32 (hi = tf32(x), lo = tf32(x - hi); hi·lo + lo·hi + hi·hi
    summed in f32), 1 = one TF32 pass, 0 = plain f32."""
    if passes == 0:
        return a @ b
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def warp_scan(x, dim):
    """Inclusive Hillis-Steele scan along ``dim``, as lanes shuffled up by
    1, 2, 4, ... add it."""
    n, d = x.shape[dim], 1
    while d < n:
        sh = torch.zeros_like(x)
        sh.narrow(dim, d, n - d).copy_(x.narrow(dim, 0, n - d))
        x, d = x + sh, 2 * d
    return x


def excl_shift(x, dim):
    """Every row moved one down, row 0 = 0: the exclusive prefix from the
    inclusive one (the same floats, as the kernels take it)."""
    return torch.cat([torch.zeros_like(x.narrow(dim, 0, 1)),
                      x.narrow(dim, 0, x.shape[dim] - 1)], dim)


def _pad_rows(x, rows):
    """Dim 1 zero-padded to ``rows``: the masked rows of a ragged tile."""
    pad = rows - x.shape[1]
    if pad == 0:
        return x
    return torch.cat([x, torch.zeros((x.shape[0], pad) + tuple(x.shape[2:]))], 1)


def wkv_sub_block_scans(x, sub):
    """``csrc/rwkv6_scan.cu::sub_scan`` on (B,H,T,K) log2 decays: inside each
    ``sub``-row sub-block one thread per channel sums the rows in order,
    forward for the prefix and backward from the sub-block's end for the
    suffix → per sub-block (inclusive prefix, exclusive prefix, exclusive
    suffix) (B,H,n,sub,K), and the prefix and suffix totals (B,H,n,K)."""
    b, h, t, k = x.shape
    xs = x.reshape(b, h, t // sub, sub, k)
    inc = [xs[:, :, :, 0]]
    for i in range(1, sub):
        inc.append(inc[-1] + xs[:, :, :, i])
    suf = [torch.zeros_like(xs[:, :, :, 0])]
    acc = xs[:, :, :, sub - 1]
    for i in range(sub - 2, -1, -1):
        suf.append(acc)
        acc = xs[:, :, :, i] + acc
    inc = torch.stack(inc, 3)
    return inc, excl_shift(inc, 3), torch.stack(suf[::-1], 3), inc[:, :, :, -1], acc


def rwkv6_tiled_model(r, k, v, logw, u, ts=FOLD_TILE, sub=SUB_BLOCK, vs=STATE_COLUMNS,
                      passes=3):
    """``csrc/rwkv6_scan.cu`` in torch: fold tiles of ``ts`` rows whatever the
    chunk, the last one ragged and masked (r = k = v = 0, logw = 0); decay
    scans inside ``sub``-row sub-blocks, and the tile's prefix, suffix and
    total as sums of the sub-blocks' own (every exponent a direct sum); A pairwise on the diagonal
    sub-blocks (exponents <= 0) and, off them, the product of r ⊙ exp(the
    sub-block's exclusive prefix) and k ⊙ exp(the later sub-block's
    exclusive suffix, plus the totals between); the state carried in
    ``vs``-column slices; every product through ``mm``."""
    b, s, h, dk = r.shape
    st = torch.zeros(b, h, dk, dk)
    nsub = ts // sub
    tri = torch.tril(torch.ones(sub, sub, dtype=torch.bool), diagonal=-1)
    ys = []
    for t0 in range(0, s, ts):
        rt, kt, vt, wt = (_pad_rows(x[:, t0:t0 + ts], ts).transpose(1, 2)
                          for x in (r, k, v, logw))                       # (B,H,T,K)
        inc, ex, suf, ptot, stot = wkv_sub_block_scans(wt * LOG2E, sub)

        def span(tots, i, j):   # total of sub-blocks i..j-1
            return sum((tots[:, :, m] for m in range(i, j)), torch.zeros(b, h, dk))

        # the tile's prefix from the prefix totals of the sub-blocks before,
        # its suffix and total from the suffix totals (summed from the end)
        tex = torch.cat([span(ptot, 0, i)[:, :, None] + ex[:, :, i] if i else ex[:, :, i]
                         for i in range(nsub)], 2)
        tsuf = torch.cat([suf[:, :, i] + span(stot, i + 1, nsub)[:, :, None] if i < nsub - 1
                          else suf[:, :, i] for i in range(nsub)], 2)
        rw, kw = rt * torch.exp2(tex), kt * torch.exp2(tsuf)
        dec = torch.exp2(stot[:, :, 0] + span(stot, 1, nsub))[..., None]  # (B,H,K,1)
        amat = torch.zeros(b, h, ts, ts)
        for i in range(nsub):
            bi = slice(i * sub, (i + 1) * sub)
            pair = torch.where(tri[:, :, None],
                               torch.exp2(ex[:, :, i, :, None, :] - inc[:, :, i, None, :, :]),
                               torch.zeros(()))
            blk = torch.einsum("bhtk,bhuk,bhtuk->bhtu", rt[:, :, bi], kt[:, :, bi], pair)
            amat[:, :, bi, bi] = blk + torch.diag_embed(
                torch.einsum("bhtk,hk,bhtk->bht", rt[:, :, bi], u, kt[:, :, bi]))
            for j in range(i):
                bj = slice(j * sub, (j + 1) * sub)
                rf = rt[:, :, bi] * torch.exp2(ex[:, :, i])
                kf = kt[:, :, bj] * torch.exp2(suf[:, :, j] + span(stot, j + 1, i)[:, :, None])
                amat[:, :, bi, bj] = mm(rf, kf.transpose(-1, -2), passes)
        y = torch.empty(b, h, ts, dk)
        for j0 in range(0, dk, vs):
            js = slice(j0, j0 + vs)
            y[..., js] = mm(amat, vt[..., js], passes) + mm(rw, st[..., js], passes)
            st[..., js] = dec * st[..., js] + mm(kw.transpose(-1, -2), vt[..., js], passes)
        ys.append(y.transpose(1, 2)[:, :min(ts, s - t0)])
    return torch.cat(ys, 1)


def scan_rows(x, dim):
    """The SSD kernel's scan of 64 rows: 32 a warp pass (a lane a row), the
    second half offset by the first half's total."""
    n = x.shape[dim]
    if n <= 32:
        return warp_scan(x, dim)
    lo = warp_scan(x.narrow(dim, 0, 32), dim)
    hi = warp_scan(x.narrow(dim, 32, n - 32), dim) + lo.narrow(dim, 31, 1)
    return torch.cat([lo, hi], dim)


def mamba2_tiled_model(x, dt, a, bm, cm, sub=SUB_TILE, ps=STATE_ROWS, passes=3):
    """``csrc/mamba2_ssd.cu`` in torch: ``sub``-row sub-tiles whatever the
    caller's chunk, the last one ragged and masked (zero rows, so dt = 0);
    C·Bᵀ once per sub-tile for all heads; per head the gate C·Bᵀ ⊙
    exp(cum_t − cum_u) ⊙ dt_u, the read of the carried state and the fold
    with exp(suffix) ⊙ dt, the suffix summed backward from the sub-tile's
    end; the state carried in ``ps``-row slices; every product through
    ``mm``."""
    b, s, h, p = x.shape
    st = torch.zeros(b, h, p, bm.shape[-1])
    tri = torch.tril(torch.ones(sub, sub, dtype=torch.bool))
    ys = []
    for t0 in range(0, s, sub):
        xt = _pad_rows(x[:, t0:t0 + sub], sub).transpose(1, 2)         # (B,H,T,P)
        dtt = _pad_rows(dt[:, t0:t0 + sub], sub).transpose(1, 2)       # (B,H,T)
        bt = _pad_rows(bm[:, t0:t0 + sub], sub)[:, None]               # (B,1,T,N)
        ct = _pad_rows(cm[:, t0:t0 + sub], sub)[:, None]
        da = dtt * a[None, :, None] * LOG2E
        cum = scan_rows(da, 2)
        sfx = scan_rows(da.flip(2), 2).flip(2)                          # inclusive suffix
        suf = torch.cat([sfx[..., 1:], torch.zeros_like(sfx[..., :1])], 2)
        ec, wt, tot = torch.exp2(cum), torch.exp2(suf) * dtt, torch.exp2(sfx[..., :1])
        scores = mm(ct, bt.transpose(-1, -2), passes)                  # (B,1,T,U)
        gate = torch.where(tri, scores * torch.exp2(cum[..., :, None] - cum[..., None, :])
                           * dtt[..., None, :], torch.zeros(()))
        y = torch.empty(b, h, sub, p)
        for p0 in range(0, p, ps):
            sl = slice(p0, p0 + ps)
            y[..., sl] = mm(gate, xt[..., sl], passes) \
                + ec[..., None] * mm(ct, st[:, :, sl].transpose(-1, -2), passes)
            st[:, :, sl] = tot[..., None] * st[:, :, sl] \
                + mm((wt[..., None] * xt[..., sl]).transpose(-1, -2), bt, passes)
        ys.append(y.transpose(1, 2)[:, :min(sub, s - t0)])
    return torch.cat(ys, 1)


def _worst(got, want, tol=SCAN):
    """Largest |got - want| over its limit atol + rtol |want|."""
    return ((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max().item()


@pytest.mark.parametrize("b,s,h,dk", RWKV_SHAPES)
@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
@pytest.mark.parametrize("decay_strength", [0.5, 6.0])
def test_rwkv6_tiled_arithmetic_matches_recurrence(b, s, h, dk, chunk, decay_strength):
    """The kernel's arithmetic (which walks its own fold tile whatever the
    chunk) against the recurrence, and against the Pallas kernel at this
    chunk."""
    args = _rwkv_inputs(b, s, h, dk, decay_strength)
    got = rwkv6_tiled_model(*_t(*args))
    np.testing.assert_allclose(got.numpy(), R.rwkv6_wkv_ref(*_t(*args)).numpy(), **SCAN)
    want = rwkv6_wkv_fwd(*_j(*args), chunk=chunk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN)


@pytest.mark.parametrize("s", [37, 96, 100])
@pytest.mark.parametrize("ts", [16, FOLD_TILE])
@pytest.mark.parametrize("decay_strength", [0.5, 6.0])
def test_rwkv6_tiled_arithmetic_ragged_lengths(s, ts, decay_strength):
    """Prefill lengths that are no multiple of the fold tile (S = 37, where
    the model's chunk is 1, and 96 and 100): the masked last tile."""
    r, k, v, logw, u = _t(*_rwkv_inputs(2, s, 2, 32, decay_strength))
    np.testing.assert_allclose(rwkv6_tiled_model(r, k, v, logw, u, ts=ts).numpy(),
                               R.rwkv6_wkv_ref(r, k, v, logw, u).numpy(), **SCAN)


def test_rwkv6_tiled_arithmetic_strong_decay_and_chunk_invariance():
    """logw = -25 stays finite through the factorised off-diagonal block;
    and the fold tile is the kernel's choice: 16, 32 and 64 rows (16-row
    sub-blocks each) agree at the reference's chunk-invariance 1e-5
    (``test_kernels.py:125-149``), so any chunk gives the same result."""
    r, k, v, _, u = _t(*_rwkv_inputs(1, 64, 1, 16, 1.0, seed=15))
    logw = torch.full_like(r, -25.0)
    got = rwkv6_tiled_model(r, k, v, logw, u)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), R.rwkv6_wkv_ref(r, k, v, logw, u).numpy(), **SCAN)

    args = _t(*_rwkv_inputs(1, 128, 1, 64, 6.0))
    outs = [rwkv6_tiled_model(*args, ts=ts).numpy() for ts in (16, 32, 64)]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("decay_strength,logw", [(0.5, None), (6.0, None), (1.0, -25.0)])
def test_rwkv6_single_tf32_pass_breaks_tolerance(decay_strength, logw):
    """Why every product is split: with its operands rounded to TF32 once
    (~10 mantissa bits) the scan misses 2e-4 many times over; split it
    passes."""
    r, k, v, lw, u = _t(*_rwkv_inputs(1, 128, 1, 64, decay_strength))
    if logw is not None:
        lw = torch.full_like(r, logw)
    want = R.rwkv6_wkv_ref(r, k, v, lw, u)
    assert _worst(rwkv6_tiled_model(r, k, v, lw, u, passes=1), want) > 2.0
    assert _worst(rwkv6_tiled_model(r, k, v, lw, u), want) < 1.0


def _reference_fold(r, k, v, logw, u, ts):
    """The TPU kernel's own fold (``rwkv6_scan.py::_fold_tile``, pairwise
    scores from prefix sums over the whole tile) over tiles of ``ts`` rows,
    numpy in and out."""
    b, s, h, dk = r.shape
    fold = jax.jit(jax.vmap(_fold_tile))
    rows = [jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, dk)) for x in (r, k, v, logw)]
    uu = jnp.asarray(np.tile(u, (b, 1)))
    st = jnp.zeros((b * h, dk, dk), jnp.float32)
    ys = []
    for t0 in range(0, s, ts):
        y, st = fold(*(x[:, t0:t0 + ts] for x in rows), uu, st)
        ys.append(np.asarray(y))
    return np.concatenate(ys, 1).reshape(b, h, s, dk).transpose(0, 2, 1, 3)


def test_rwkv6_64_row_fold_breaks_tolerance():
    """Why no later change may widen the fold the TPU kernel's way: its
    fold over 64-row tiles (pairwise scores from 64-row prefix sums, whose
    differences lose the low bits of the exponents near 0) misses 2e-4 at
    decay strength 6.0 even in f32, where its 32-row tile passes; the
    kernel's arithmetic, whose every exponent is a sum inside a 16-row
    sub-block, passes at 64 rows too."""
    args = _rwkv_inputs(4, 256, 4, 64, 6.0)
    want = R.rwkv6_wkv_ref(*_t(*args))
    assert _worst(torch.from_numpy(_reference_fold(*args, 64)), want) > 1.0
    assert _worst(torch.from_numpy(_reference_fold(*args, 32)), want) < 1.0
    assert _worst(rwkv6_tiled_model(*_t(*args), ts=64, passes=0), want) < 1.0


@pytest.mark.parametrize("b,s,h,p,n", MAMBA_SHAPES + [(1, 100, 2, 8, 16), (1, 256, 2, 64, 64),
                                                      (1, 37, 2, 32, 32), (2, 96, 3, 16, 64)])
def test_mamba2_tiled_arithmetic_matches_recurrence(b, s, h, p, n):
    """64-row sub-tiles, ragged at S = 37, 96 and 100, and four of them
    inside one 256-row chunk at zamba2's P = N = 64; one and two 32-row
    slices of the state."""
    args = _t(*_mamba_inputs(b, s, h, p, n))
    np.testing.assert_allclose(mamba2_tiled_model(*args).numpy(),
                               R.mamba2_ssd_ref(*args).numpy(), **SCAN)


@pytest.mark.parametrize("chunk,head_block", [(16, 2), (32, 4), (64, 8)])
def test_mamba2_tiled_arithmetic_matches_pallas(chunk, head_block):
    """Through the recurrence to the Pallas kernel at the chunk and head
    block it was given (the kernel's result depends on neither)."""
    args = _mamba_inputs(2, 128, 8, 16, 24)
    want = mamba2_ssd_fwd(*_j(*args), chunk=chunk, head_block=head_block, interpret=True)
    np.testing.assert_allclose(mamba2_tiled_model(*_t(*args)).numpy(), np.asarray(want), **SCAN)


def test_mamba2_tiled_arithmetic_sub_tile_invariance():
    """The sub-tile is the kernel's choice: 16, 32 and 64 rows agree at the
    reference's chunk-invariance tolerance 1e-4 (``test_kernels.py:170-180``)."""
    args = _t(*_mamba_inputs(1, 128, 4, 8, 16, seed=25))
    outs = [mamba2_tiled_model(*args, sub=t).numpy() for t in (16, 32, 64)]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,s,h,p,n", [(1, 64, 4, 16, 16), (1, 128, 2, 64, 64)])
def test_mamba2_single_tf32_pass_breaks_tolerance(b, s, h, p, n):
    """Why every product is split: one TF32 pass misses 2e-4 many times
    over; split TF32 passes."""
    args = _t(*_mamba_inputs(b, s, h, p, n))
    want = R.mamba2_ssd_ref(*args)
    assert _worst(mamba2_tiled_model(*args, passes=1), want) > 2.0
    assert _worst(mamba2_tiled_model(*args), want) < 1.0
