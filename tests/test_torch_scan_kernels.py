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
- the arithmetic of each CUDA kernel written out in torch (the tiles,
  the order of its prefix and suffix sums, the state it carries), held
  against the recurrence at 2e-4 and across chunk or sub-tile sizes at
  the reference's 1e-5 (RWKV6) and 1e-4 (Mamba2).

The CUDA kernels themselves are held against the plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.mamba2_ssd import mamba2_ssd_fwd  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_wkv_fwd  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels.mamba2_ssd import mamba2_ssd_cuda  # noqa: E402
from repro_torch.kernels.rwkv6_scan import STATE_TILE, rwkv6_wkv_cuda  # noqa: E402

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
def rwkv6_tiled_model(r, k, v, logw, u, ts):
    """``csrc/rwkv6_scan.cu`` in torch: tiles of ``ts`` rows; per column the
    exclusive and inclusive prefix sums run forward from the tile's start
    and the suffix sum backward from its end, one position at a time, as the
    kernel's scan threads add them; the (K×K) state carries across tiles."""
    b, s, h, dk = r.shape
    st = torch.zeros(b, h, dk, dk)
    ys = []
    tri = torch.tril(torch.ones(ts, ts, dtype=torch.bool), diagonal=-1)
    for t0 in range(0, s, ts):
        rt, kt, vt, wt = (x[:, t0:t0 + ts].transpose(1, 2) for x in (r, k, v, logw))  # (B,H,T,K)
        ex, inc, acc = [], [], torch.zeros(b, h, dk)
        for t in range(ts):
            ex.append(acc)
            acc = acc + wt[:, :, t]
            inc.append(acc)
        ex, inc = torch.stack(ex, 2), torch.stack(inc, 2)
        suf, acc = [None] * ts, torch.zeros(b, h, dk)
        for t in reversed(range(ts)):
            suf[t] = acc
            acc = acc + wt[:, :, t]
        suf, total = torch.stack(suf, 2), acc
        # only u < t is evaluated, where every exponent is <= 0
        pair = torch.where(tri[:, :, None], torch.exp(ex[:, :, :, None] - inc[:, :, None, :]),
                           torch.zeros(()))                                # (B,H,T,U,K)
        amat = torch.einsum("bhtk,bhuk,bhtuk->bhtu", rt, kt, pair)
        amat = amat + torch.diag_embed(torch.einsum("bhtk,hk,bhtk->bht", rt, u, kt))
        y = amat @ vt + (rt * torch.exp(ex)) @ st
        st = st * torch.exp(total)[..., None] + (kt * torch.exp(suf)).transpose(-1, -2) @ vt
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, 1)


def mamba2_tiled_model(x, dt, a, bm, cm, sub=64):
    """``csrc/mamba2_ssd.cu`` in torch: ``sub``-row sub-tiles whatever the
    caller's chunk, the last one ragged and masked (dt = 0 rows); per head
    the gate C·Bᵀ ⊙ exp(cum_t − cum_u) ⊙ dt_u, the read of the carried (P×N)
    state, and the fold with exp(suffix) ⊙ dt from a backward sum."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    st = torch.zeros(b, h, p, n)
    ys = []
    for t0 in range(0, s, sub):
        xt, dtt = x[:, t0:t0 + sub], dt[:, t0:t0 + sub]
        bt, ct = bm[:, t0:t0 + sub], cm[:, t0:t0 + sub]
        rows = xt.shape[1]
        if rows < sub:                      # the masked rows of a ragged tile
            pad = sub - rows
            xt = torch.cat([xt, torch.zeros(b, pad, h, p)], 1)
            dtt = torch.cat([dtt, torch.zeros(b, pad, h)], 1)
            bt = torch.cat([bt, torch.zeros(b, pad, n)], 1)
            ct = torch.cat([ct, torch.zeros(b, pad, n)], 1)
        da = dtt * a                                         # (B,T,H)
        cum, acc = [], torch.zeros(b, h)
        for t in range(sub):
            acc = acc + da[:, t]
            cum.append(acc)
        cum = torch.stack(cum, 1)
        wt, acc = [None] * sub, torch.zeros(b, h)
        for t in reversed(range(sub)):
            wt[t] = torch.exp(acc) * dtt[:, t]
            acc = acc + da[:, t]
        wt, tot = torch.stack(wt, 1), torch.exp(acc)
        scores = ct @ bt.transpose(1, 2)                     # (B,T,U)
        gate = torch.exp(cum[:, :, None, :] - cum[:, None, :, :]) * dtt[:, None, :, :]
        gate = torch.where(torch.tril(torch.ones(sub, sub, dtype=torch.bool))[None, :, :, None],
                           scores[..., None] * gate, torch.zeros(()))
        y = torch.einsum("btuh,buhp->bthp", gate, xt)
        y = y + torch.exp(cum)[..., None] * torch.einsum("btn,bhpn->bthp", ct, st)
        st = st * tot[:, :, None, None] + torch.einsum("bth,bthp,btn->bhpn", wt, xt, bt)
        ys.append(y[:, :rows])
    return torch.cat(ys, 1)


@pytest.mark.parametrize("b,s,h,dk", RWKV_SHAPES)
@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
@pytest.mark.parametrize("decay_strength", [0.5, 6.0])
def test_rwkv6_tiled_arithmetic_matches_recurrence(b, s, h, dk, chunk, decay_strength):
    r, k, v, logw, u = _t(*_rwkv_inputs(b, s, h, dk, decay_strength))
    got = rwkv6_tiled_model(r, k, v, logw, u, min(chunk, STATE_TILE))
    np.testing.assert_allclose(got.numpy(), R.rwkv6_wkv_ref(r, k, v, logw, u).numpy(), **SCAN)


def test_rwkv6_tiled_arithmetic_strong_decay_and_chunk_invariance():
    """logw = -25 stays finite; and chunks 32, 64, 128 fold through the
    same 32-row tiles (the kernel takes ts = min(chunk, 32)), so they agree
    at the reference's 1e-5 (``test_kernels.py:125-149``)."""
    r, k, v, _, u = _t(*_rwkv_inputs(1, 64, 1, 16, 1.0, seed=15))
    logw = torch.full_like(r, -25.0)
    got = rwkv6_tiled_model(r, k, v, logw, u, 32)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), R.rwkv6_wkv_ref(r, k, v, logw, u).numpy(), **SCAN)

    args = _t(*_rwkv_inputs(1, 128, 1, 64, 6.0))
    outs = [rwkv6_tiled_model(*args, min(c, STATE_TILE)).numpy() for c in (32, 64, 128)]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,s,h,p,n", MAMBA_SHAPES + [(1, 100, 2, 8, 16), (1, 256, 2, 64, 64)])
def test_mamba2_tiled_arithmetic_matches_recurrence(b, s, h, p, n):
    """64-row sub-tiles, ragged at S = 100, and four of them inside one
    256-row chunk at zamba2's P = N = 64."""
    args = _t(*_mamba_inputs(b, s, h, p, n))
    np.testing.assert_allclose(mamba2_tiled_model(*args).numpy(),
                               R.mamba2_ssd_ref(*args).numpy(), **SCAN)


def test_mamba2_tiled_arithmetic_sub_tile_invariance():
    """The sub-tile is the kernel's choice: 16, 32 and 64 rows agree at the
    reference's chunk-invariance tolerance 1e-4 (``test_kernels.py:170-180``)."""
    args = _t(*_mamba_inputs(1, 128, 4, 8, 16, seed=25))
    outs = [mamba2_tiled_model(*args, sub=t).numpy() for t in (16, 32, 64)]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], atol=1e-4, rtol=1e-4)
