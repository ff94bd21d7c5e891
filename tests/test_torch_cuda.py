"""The hand-written CUDA kernels against their plain PyTorch versions on the
card (marked ``cuda``; each test skips when ``torch.cuda.is_available()``
is false, so on a CPU-only machine they all skip).  Run on the card with::

    python -m pytest -m cuda tests/test_torch_cuda.py -q

Imports torch and numpy only, so it runs where JAX is not installed.  Shapes
are the reference sweep's (``tests/test_kernels.py``) plus ragged sequence
and cache lengths, every supported head_dim (80 is zamba2's), and decode
splits at the cluster cap.  The attention kernels compute in f32 (bf16
flash carries P as bf16 hi + lo, within 2**-16 of p) and round the output
to q's dtype once, so each is held against its plain version computed in
f32 on the same inputs.  Tolerance: f32 2e-5 (the
reference sweep's; summation order); bf16 the same plus half a bf16 ulp of
the value, at most 2**-8 of it (rtol 4e-3).  The scan kernels take and
return f32 and are held against the step recurrences at the reference
sweep's 2e-4 (``test_kernels.py:96-180``).  TF32 off.

The scans' backward kernels are held against their plain versions
(``wkv_chunked_grads`` / ``ssd_chunked_grads``: the reference's chunked
form differentiated under autograd, in f32 on the card) at ``GRAD_BAND``
of each gradient's largest element.  Why 1e-3: both sides are f32, and the
plain version's own rounding against the f64 recurrence reaches 3e-5 to
1e-4 of a leaf's largest element where a gradient is a sum over the whole
sequence (da, dlogw, ddt; a CPU estimate at 512 steps).  One exception:
where dlogw is of order exp(-25) (logw = -25) the kernel's reverse sum
cancels f32 terms of order 1e2, which resolves dlogw only to an absolute
error near 1e-4 (1.0e-4 at (2, 1024, 40, 64) on the H100); that leaf is
held at ``DLOGW_ATOL``, absolute, against the plain version and against
the f64 recurrence (the chunked form's gradient in f64).
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.analysis.sentinel import TimingHazardError, TraceSentinel  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels.decode_attention import MAX_SPLITS, decode_attention_cuda, \
    splits_for  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.mamba2_ssd import mamba2_ssd_bwd_cuda, mamba2_ssd_cuda, \
    ssd_chunked_grads  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_wkv_bwd_cuda, rwkv6_wkv_cuda, \
    wkv_chunked_grads  # noqa: E402

TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-5, rtol=4e-3)}

# bf16 runs the wgmma/TMA kernel: every head_dim (16 and 80 take the 32-byte
# swizzle, 32 the 64-byte, 64 and 128 the 128-byte), G = H/K of 1, 2, 4 and
# 8, ragged S (100, 200) and S below one 128-row q tile (64, 96)
FLASH_SHAPES = [(1, 128, 4, 4, 32), (2, 256, 4, 2, 32), (1, 128, 8, 1, 64), (1, 100, 4, 2, 128),
                (2, 256, 4, 4, 80), (1, 64, 2, 2, 16), (2, 96, 8, 2, 64), (1, 200, 8, 1, 128),
                (1, 200, 4, 2, 80), (1, 256, 4, 1, 16)]
DECODE_SHAPES = [(2, 4, 2, 32, 256), (1, 8, 1, 64, 128), (2, 4, 4, 32, 128), (2, 8, 2, 128, 100),
                 (2, 4, 4, 80, 256)]
# the scans (tests/test_kernels.py:96-180), plus a ragged Mamba2 sub-tile
# (S = 100) and a 256-row chunk at zamba2's P = N = 64
RWKV_SHAPES = [(1, 64, 2, 16), (2, 128, 3, 32), (1, 128, 1, 64)]
MAMBA_SHAPES = [(1, 64, 4, 16, 16, 16), (2, 128, 8, 16, 24, 32), (1, 100, 4, 8, 16, 100),
                (2, 512, 8, 64, 64, 256)]
# ragged and odd lengths at state sizes P, N of 16, 32 and 64 (one chunk
# of the whole sequence), and zamba2-2.7b's full-width prefill scan
MAMBA_SHAPES += [(2, s, 4, p, n, s) for s in (37, 96, 100) for p, n in ((16, 32), (32, 64), (64, 16))]
MAMBA_SHAPES += [(4, 1024, 80, 64, 64, 256)]
SCAN = dict(atol=2e-4, rtol=2e-4)
# the scans' backward kernels (see the module's note): (b, s, h, dk,
# grad_chunk, decay strength or None for logw = -25) — the sweep's shapes,
# ragged and odd lengths with the chunk the model picks (the largest
# divisor of S up to 64), rwkv6-3b's training shape and a rank's (20 heads);
# then the edges of the WKV kernel's 64-row segments: S below one segment,
# S one row past a multiple of it, one head, logw = -25 across four segments
GRAD_BAND = 1e-3
DLOGW_ATOL = 3e-4
WKV_GRAD_SHAPES = [(1, 64, 2, 16, 16, 0.5), (2, 128, 3, 32, 64, 6.0), (1, 128, 1, 64, 64, 0.5),
                   (1, 64, 1, 16, 32, None), (2, 37, 3, 64, 37, 0.5), (2, 96, 3, 32, 48, 6.0),
                   (2, 100, 3, 16, 50, 0.5), (2, 100, 3, 64, 50, None),
                   (2, 1024, 40, 64, 64, 0.5), (2, 1024, 40, 64, 64, 6.0),
                   (2, 1024, 40, 64, 64, None), (2, 1024, 20, 64, 64, 0.5),
                   (2, 40, 3, 64, 40, 0.5), (1, 129, 2, 32, 43, 0.5), (2, 65, 1, 64, 13, 6.0),
                   (2, 200, 1, 64, 50, 0.5), (1, 256, 2, 64, 64, None)]
# (b, s, h, p, n, chunk, head_block, dt): "init" is zamba2-2.7b's initial
# dt·A = softplus(0)·-1 ≈ -0.69 a step, where the reference's gradient
# overflows over a 256-row chunk; zamba2-2.7b's training shape and a rank's
# (40 heads at head_block 8, 5 at head_block 1); then the edges of the
# kernel's segments and head groups: S below one segment, S one row past a
# multiple of it, one head, odd head counts (3, 5 and 7 heads a group) and
# 11 heads (a group of one), and zamba2's initial decay over 1024 rows
SSD_GRAD_SHAPES = [(1, 64, 4, 16, 16, 16, 2, "rand"), (2, 128, 8, 16, 24, 32, 4, "rand"),
                   (2, 37, 4, 16, 32, 37, 4, "rand"), (2, 96, 4, 32, 64, 96, 4, "rand"),
                   (2, 100, 4, 64, 16, 100, 4, "rand"), (1, 256, 4, 64, 64, 256, 4, "init"),
                   (2, 1024, 80, 64, 64, 256, 8, "rand"), (2, 1024, 80, 64, 64, 256, 8, "init"),
                   (2, 1024, 40, 64, 64, 256, 8, "rand"), (2, 1024, 5, 64, 64, 256, 1, "rand"),
                   (2, 40, 4, 32, 64, 40, 4, "rand"), (1, 129, 3, 64, 64, 129, 3, "rand"),
                   (2, 65, 1, 64, 64, 65, 1, "rand"), (1, 200, 5, 64, 32, 200, 5, "init"),
                   (1, 192, 7, 64, 64, 64, 7, "rand"), (1, 64, 11, 16, 16, 64, 11, "rand"),
                   (1, 1024, 12, 64, 64, 256, 4, "init")]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, dtype, seed, *shapes):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev).to(getattr(torch, dtype)) for s in shapes]


def _f32(*xs):
    return [x.float() for x in xs]


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,k,d", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain(dev, b, s, h, k, d, causal, window, dtype):
    q, kk, v = _randn(dev, dtype, 0, (b, s, h, d), (b, s, k, d), (b, s, k, d))
    n0 = flash_attention_cuda.launches
    got = K.flash_attention(q, kk, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == n0 + 1
    _close(got, R.flash_attention_ref(*_f32(q, kk, v), causal, window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,k,d,c", DECODE_SHAPES)
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("fill", [16, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_matches_plain(dev, b, h, k, d, c, window, fill, dtype):
    q, kc, vc = _randn(dev, dtype, 3, (b, h, d), (b, c, k, d), (b, c, k, d))
    pos = torch.where(torch.arange(c) < fill, torch.arange(c), -1).to(torch.int32).to(dev)
    npos = torch.tensor(fill - 1, dtype=torch.int32, device=dev)
    n0 = decode_attention_cuda.launches
    got = K.decode_attention(q, kc, vc, pos, npos, window=window)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == n0 + 1
    _close(got, R.decode_attention_ref(*_f32(q, kc, vc), pos, npos, window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,k,d,c", DECODE_SHAPES)
@pytest.mark.parametrize("fill", [0, 16, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_lse_matches_plain(dev, b, h, k, d, c, fill, dtype):
    """The decode kernel's row log-sum-exp (the tensor-parallel merge's
    weight): against the plain version's in f32 (-inf where no slot is
    allowed, fill 0), the output bit for bit the launch without it."""
    q, kc, vc = _randn(dev, dtype, 4, (b, h, d), (b, c, k, d), (b, c, k, d))
    pos = torch.where(torch.arange(c) < fill, torch.arange(c), -1).to(torch.int32).to(dev)
    npos = torch.tensor(max(fill - 1, 0), dtype=torch.int32, device=dev)
    out, lse = K.decode_attention(q, kc, vc, pos, npos, lse=True)
    plain = K.decode_attention(q, kc, vc, pos, npos)
    _, want = R.decode_attention_ref(*_f32(q, kc, vc), pos, npos, lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain) and lse.dtype == torch.float32 and lse.shape == (b, h)
    if fill == 0:
        assert torch.isneginf(lse).all()
    else:
        np.testing.assert_allclose(lse.cpu().numpy(), want.cpu().numpy(), **TOL["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,k,d,c", [(1, 8, 1, 64, 2048), (1, 32, 8, 128, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_at_cluster_cap(dev, b, h, k, d, c, dtype):
    """Batch 1: the splits reach the cluster cap of 8 (4 and 2 tiles each);
    every slot valid, with a window."""
    assert splits_for(torch.cuda.current_device(), b, h, k, c, d, getattr(torch, dtype)) \
        == MAX_SPLITS
    q, kc, vc = _randn(dev, dtype, 4, (b, h, d), (b, c, k, d), (b, c, k, d))
    pos = torch.arange(c, dtype=torch.int32, device=dev)
    npos = torch.tensor(c - 1, dtype=torch.int32, device=dev)
    for window in (None, 300):
        _close(K.decode_attention(q, kc, vc, pos, npos, window=window),
               R.decode_attention_ref(*_f32(q, kc, vc), pos, npos, window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_ring_buffer_wraparound(dev, dtype):
    c = 64
    q, kc, vc = _randn(dev, dtype, 6, (1, 2, 16), (1, c, 2, 16), (1, c, 2, 16))
    pos = torch.where(torch.arange(c) < 10, torch.arange(c) + c, torch.arange(c))
    pos = pos.to(torch.int32).to(dev)
    npos = torch.tensor(c + 9, dtype=torch.int32, device=dev)
    _close(K.decode_attention(q, kc, vc, pos, npos, window=c),
           R.decode_attention_ref(*_f32(q, kc, vc), pos, npos, c), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,dk", RWKV_SHAPES)
@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("decay_strength", [0.5, 6.0, None])   # None: logw = -25
def test_rwkv6_kernel_matches_plain(dev, b, s, h, dk, chunk, decay_strength):
    r, k, v, w, u = _randn(dev, "float32", 10, *[(b, s, h, dk)] * 4, (h, dk))
    logw = (torch.full_like(w, -25.0) if decay_strength is None
            else -torch.nn.functional.softplus(w * decay_strength))
    n0 = rwkv6_wkv_cuda.launches
    got = K.rwkv6_wkv(r, k, v, logw, u, chunk)
    torch.cuda.synchronize()
    assert rwkv6_wkv_cuda.launches == n0 + 1 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(),
                               R.rwkv6_wkv_ref(r, k, v, logw, u).cpu().numpy(), **SCAN)


def _largest_chunk(s, cap=32):
    """The largest divisor of s up to cap: the chunk the rwkv6 model picks."""
    c = min(s, cap)
    while s % c:
        c -= 1
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("s", [37, 96, 100])
@pytest.mark.parametrize("dk", [16, 32, 64])
@pytest.mark.parametrize("decay_strength", [0.5, 6.0, None])   # None: logw = -25
def test_rwkv6_kernel_ragged_lengths(dev, s, dk, decay_strength):
    """Lengths that are no multiple of the 32-row fold tile (the last tile
    masked), at every head width, with the chunk the model would pass."""
    r, k, v, w, u = _randn(dev, "float32", 11, *[(2, s, 3, dk)] * 4, (3, dk))
    logw = (torch.full_like(w, -25.0) if decay_strength is None
            else -torch.nn.functional.softplus(w * decay_strength))
    got = K.rwkv6_wkv(r, k, v, logw, u, _largest_chunk(s))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(),
                               R.rwkv6_wkv_ref(r, k, v, logw, u).cpu().numpy(), **SCAN)


@pytest.mark.cuda
@pytest.mark.parametrize("decay_strength", [0.5, 6.0, None])
def test_rwkv6_kernel_full_width(dev, decay_strength):
    """rwkv6-3b's prefill scan: (4, 1024, 40, 64), chunk 32."""
    r, k, v, w, u = _randn(dev, "float32", 12, *[(4, 1024, 40, 64)] * 4, (40, 64))
    logw = (torch.full_like(w, -25.0) if decay_strength is None
            else -torch.nn.functional.softplus(w * decay_strength))
    got = K.rwkv6_wkv(r, k, v, logw, u, 32)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(),
                               R.rwkv6_wkv_ref(r, k, v, logw, u).cpu().numpy(), **SCAN)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk", MAMBA_SHAPES)
def test_mamba2_kernel_matches_plain(dev, b, s, h, p, n, chunk):
    x, dt, a, bm, cm = _randn(dev, "float32", 20, (b, s, h, p), (b, s, h), (h,), (b, s, n),
                              (b, s, n))
    dt = torch.nn.functional.softplus(dt)
    a = -torch.exp(a * 0.2)
    n0 = mamba2_ssd_cuda.launches
    got = K.mamba2_ssd(x, dt, a, bm, cm, chunk, 4)
    torch.cuda.synchronize()
    assert mamba2_ssd_cuda.launches == n0 + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               R.mamba2_ssd_ref(x, dt, a, bm, cm).cpu().numpy(), **SCAN)


def _grad_band(got, want, name, atol=None):
    """Finite and within GRAD_BAND of ``want``'s largest |element|, or
    within ``atol``, absolute, where that is given."""
    scale = want.abs().max().item()
    band = GRAD_BAND * scale if atol is None else atol
    err = (got - want).abs().max().item()
    assert bool(torch.isfinite(got).all()) and err <= band, \
        f"{name}: max |err| {err:.3e} against a largest element {scale:.3e} (band {band:.3e})"


def _wkv_grad_inputs(dev, b, s, h, dk, decay, seed=40):
    r, k, v, w, dy = _randn(dev, "float32", seed, *[(b, s, h, dk)] * 5)
    u, = _randn(dev, "float32", seed + 1, (h, dk))
    logw = torch.full_like(w, -25.0) if decay is None \
        else -torch.nn.functional.softplus(w * decay)
    return (r, k, v, logw, u), dy


def _ssd_grad_inputs(dev, b, s, h, p, n, dt_kind, seed=42):
    x, dt, a, bm, cm, dy = _randn(dev, "float32", seed, (b, s, h, p), (b, s, h), (h,),
                                  (b, s, n), (b, s, n), (b, s, h, p))
    if dt_kind == "init":
        dt, a = torch.full_like(dt, float(np.log(2.0))), -torch.ones_like(a)
    else:
        dt, a = torch.nn.functional.softplus(dt), -torch.exp(a * 0.2)
    return (x, dt, a, bm, cm), dy


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,dk,grad_chunk,decay", WKV_GRAD_SHAPES)
def test_wkv_bwd_kernel_matches_plain(dev, b, s, h, dk, grad_chunk, decay):
    """(dr, dk, dv, dlogw, du) against the chunked form's autograd gradient
    at GRAD_BAND, finite (logw = -25 included, where dlogw is held at
    DLOGW_ATOL against it and against the f64 recurrence's), the same bits
    on a second call; one launch a call."""
    ins, dy = _wkv_grad_inputs(dev, b, s, h, dk, decay)
    n0 = rwkv6_wkv_bwd_cuda.launches
    got = rwkv6_wkv_bwd_cuda(*ins, dy, grad_chunk)
    again = rwkv6_wkv_bwd_cuda(*ins, dy, grad_chunk)
    torch.cuda.synchronize()
    assert rwkv6_wkv_bwd_cuda.launches == n0 + 2
    want = wkv_chunked_grads(ins, grad_chunk, dy)
    for name, g, g2, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, again, want):
        assert g.shape == w.shape and torch.equal(g, g2), name
        _grad_band(g, w, name, DLOGW_ATOL if name == "dlogw" and decay is None else None)
    if decay is None:
        exact = wkv_chunked_grads([t.double() for t in ins], grad_chunk, dy.double())[3]
        _grad_band(got[3].double(), exact, "dlogw against the f64 recurrence", DLOGW_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk,hb,dt_kind", SSD_GRAD_SHAPES)
def test_ssd_bwd_kernel_matches_plain(dev, b, s, h, p, n, chunk, hb, dt_kind):
    """(dx, ddt, da, dB, dC) against the chunked form's autograd gradient at
    GRAD_BAND, finite (zamba2's initial decay over 256 rows included), the
    same bits on a second call; one launch a call."""
    ins, dy = _ssd_grad_inputs(dev, b, s, h, p, n, dt_kind)
    n0 = mamba2_ssd_bwd_cuda.launches
    got = mamba2_ssd_bwd_cuda(*ins, dy, chunk, hb)
    again = mamba2_ssd_bwd_cuda(*ins, dy, chunk, hb)
    torch.cuda.synchronize()
    assert mamba2_ssd_bwd_cuda.launches == n0 + 2
    want = ssd_chunked_grads(ins, chunk, dy)
    for name, g, g2, w in zip(("dx", "ddt", "da", "dB", "dC"), got, again, want):
        assert g.shape == w.shape and torch.equal(g, g2), name
        _grad_band(g, w, name)


@pytest.mark.cuda
def test_scan_bwd_kernels_take_a_non_contiguous_dy(dev):
    """A dy that autograd hands over strided gives the bits of its
    contiguous copy; the wrappers check the reference's chunk rules."""
    ins, dy = _wkv_grad_inputs(dev, 2, 96, 3, 32, 0.5)
    strided = dy.transpose(2, 3).contiguous().transpose(2, 3)
    assert not strided.is_contiguous() and torch.equal(strided, dy)
    for g, w in zip(rwkv6_wkv_bwd_cuda(*ins, strided, 48), rwkv6_wkv_bwd_cuda(*ins, dy, 48)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="grad_chunk"):
        rwkv6_wkv_bwd_cuda(*ins, dy, 64)
    ins, dy = _ssd_grad_inputs(dev, 2, 64, 4, 16, 16, "rand")
    strided = dy.transpose(2, 3).contiguous().transpose(2, 3)
    for g, w in zip(mamba2_ssd_bwd_cuda(*ins, strided, 32, 2),
                    mamba2_ssd_bwd_cuda(*ins, dy, 32, 2)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="chunk"):
        mamba2_ssd_bwd_cuda(*ins, dy, 48, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
def test_scan_plain_gradients_never_run_on_the_card(dev, arch, monkeypatch):
    """The smoke model's loss and gradients on the card with the plain
    gradients (wkv_chunked_grads, ssd_chunked_grads) made to raise: the
    backward kernels carry every scan's gradient, one launch a layer."""
    import importlib

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import DataConfig, make_batch_np
    from repro_torch.train.data import to_device

    def refuse(*args, **kw):
        raise AssertionError("a scan's plain gradient ran on the card")

    # the modules, not the kernels package's functions of the same names
    wkv_mod = importlib.import_module("repro_torch.kernels.rwkv6_scan")
    ssd_mod = importlib.import_module("repro_torch.kernels.mamba2_ssd")
    monkeypatch.setattr(wkv_mod, "wkv_chunked_grads", refuse)
    monkeypatch.setattr(ssd_mod, "ssd_chunked_grads", refuse)
    model = Model(get_config(arch, smoke=True))
    params = model.init(seed=3, device=dev)
    leaves = [p.requires_grad_() for p in _leaves(params)]
    batch = to_device(make_batch_np(model.cfg, DataConfig(2, 64), 0), dev)
    K.reset_launch_counts()
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    want = _train_launches(model)
    assert K.launch_counts() == want
    assert want["rwkv6_wkv_bwd" if arch == "rwkv6-3b" else "mamba2_ssd_bwd"] \
        == model.cfg.num_layers
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,seq", [("qwen3-4b", 64), ("rwkv6-3b", 64), ("zamba2-2.7b", 64),
                                      ("olmoe-1b-7b", 64), ("mixtral-8x22b", 64),
                                      ("granite-20b", 64), ("qwen2-7b", 64), ("yi-6b", 64)])
def test_model_cuda_path_matches_cpu_path(dev, arch, seq):
    """The small model through the kernels against the same model through
    the plain versions (which tests/test_torch_serve.py and
    tests/test_torch_recurrent.py hold against JAX); 1e-3 since cuBLAS and
    the CPU sum in different orders."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    model = Model(get_config(arch, smoke=True))
    p_cpu = model.init(seed=1, device="cpu")
    p_gpu = _to(p_cpu, dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, seq)))
    with torch.inference_mode():
        want = model.prefill(p_cpu, {"tokens": toks})
        got = model.prefill(p_gpu, {"tokens": toks.to(dev)}).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3, rtol=1e-3)


def _to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return {k: _to(v, dev) for k, v in tree.items()}


# ------------------------------------------------------------ perception --
# The perception path runs none of the kernels above: its device work is
# plain torch ops.  On the card it is held against its own CPU run (which
# tests/test_torch_perception.py holds against JAX), from the same seed-7
# weights: counts equal, boxes within 1e-3 px (chip_smoke.py's bound).

@pytest.fixture
def tf32_default():
    """cuDNN's TF32 at torch's default (on), so the backbone's own f32
    setting is what the tests exercise."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("name,scale,pad", [
    ("one_stage", 1.0, True), ("early_exit", 1.0, True), ("two_stage", 1.0, True),
    ("lane", 1.0, True), ("lane_static", 1.0, True), ("one_stage", 0.75, False),
    ("early_exit", 0.5, False)])
def test_perception_card_matches_cpu(dev, tf32_default, name, scale, pad):
    from repro_torch import kernels as K2
    from repro_torch.perception import SceneConfig, build_pipeline, run_pipeline

    K2.reset_launch_counts()
    for scenario, rain in (("city", 0.0), ("road", 0.0), ("city", 50.0)):
        cfg = SceneConfig(scenario, rain)
        outs = [run_pipeline(name, cfg, n=4, collect=True,
                             built=build_pipeline(name, scale=scale, pad=pad, device=d))[1]
                for d in (dev, "cpu")]
        for (_, g), (_, w) in zip(*outs):
            assert (g.num_proposals, g.num_objects) == (w.num_proposals, w.num_objects)
            assert g.boxes.shape == w.boxes.shape
            np.testing.assert_allclose(g.boxes, w.boxes, atol=1e-3, rtol=0)
    assert not any(K2.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("shape", [(96, 320), (87, 251)])
def test_backbone_is_f32_on_card(dev, tf32_default, depth, shape):
    """TF32 convolutions would miss 1e-5 by two orders of magnitude."""
    from repro_torch.perception import detector as D

    p = D.OneStageDetector().init(torch.Generator().manual_seed(7), "cpu")["backbone"]
    x = torch.from_numpy(np.random.default_rng(depth).standard_normal((2, *shape, 3),
                                                                      dtype=np.float32))
    want = D.backbone_apply(p, x, depth)
    got = D.backbone_apply(_to(p, dev), x.to(dev), depth)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [8, 16, 32])
def test_pool_gives_the_same_bits_on_card(dev, size):
    """The pooled luma is a fixed order of elementwise adds: the same bits
    on both devices."""
    from repro_torch.perception import detector as D

    img = torch.from_numpy(np.random.default_rng(size).uniform(0, 1, (96, 320, 3))
                           .astype(np.float32))
    for mode in ("avg", "max"):
        assert torch.equal(D._pool(img.to(dev), size, mode).cpu(), D._pool(img, size, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [(0.2, 0.5, 0.9), (0.7,), (0.3, 0.6)])
def test_static_nms_tie_order_on_card(dev, levels):
    """Equal scores rank lower index first on the card too."""
    from repro_torch.perception import detector as D

    rng = np.random.default_rng(len(levels))
    yx = rng.uniform(0, 80, (40, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([yx, yx + rng.uniform(6, 30, (40, 2))], 1)
                             .astype(np.float32))
    scores = torch.from_numpy(rng.choice(np.float32(levels), 40))
    want = D.static_nms(boxes, scores, 32)
    got = D.static_nms(boxes.to(dev), scores.to(dev), 32)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_to_host_reads_a_tree_back(dev):
    from repro_torch.core.timing import to_host

    a = torch.arange(6.0, device=dev).reshape(2, 3)
    tree = (a, {"k": a > 2, "n": a.sum()}, [a.int()])
    host = to_host(tree)
    assert isinstance(host[0], np.ndarray) and host[1]["k"].dtype == np.bool_
    assert np.array_equal(host[0], np.arange(6.0).reshape(2, 3)) and host[1]["n"] == 15.0
    assert np.array_equal(host[2][0], np.arange(6).reshape(2, 3))


@pytest.mark.cuda
def test_importing_perception_creates_no_cuda_context(dev):
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    code = ("import torch, repro_torch.perception, repro_torch.anytime\n"
            "assert torch.cuda.is_available() and not torch.cuda.is_initialized()\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(repo / "src")), timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


# --------------------------------------------------------------- batched --
# The batched engine's step is one CUDA graph per engine (repro_torch.batched):
# captured once, replayed every tick, never run eagerly on the card.

def _scene_images(n, seed0=60):
    from repro_torch.perception import SceneConfig, generate_scene

    return [generate_scene(SceneConfig(("city", "road", "residential")[i % 3], seed=seed0 + i),
                           i + 1).image for i in range(n)]


@pytest.mark.cuda
def test_batched_step_is_captured_once_through_churn(dev, tf32_default):
    from repro_torch.batched import BatchedPerceptionEngine

    eng = BatchedPerceptionEngine("early_exit", capacity=4, device=dev)
    img = _scene_images(1)[0]
    eng.compile()
    with TraceSentinel(compile_budget=0, transfer_guard="disallow") as sent:
        eng.join("a")
        eng.join("b")
        eng.tick({"a": img, "b": img})
        eng.join("c")
        eng.tick({"a": img, "b": img, "c": img})
        eng.leave("b")
        eng.tick({"a": img, "c": img})
        eng.leave("a")
        eng.leave("c")
        eng.join("d")
        _, outs = eng.tick({"d": img})
    assert sent.report().compiles == 0
    assert (eng.trace_count, eng.replay_count, eng.ticks) == (1, 4, 4)
    assert set(outs) == {"d"}


@pytest.mark.cuda
@pytest.mark.parametrize("name,scale,pad", [("two_stage", 1.0, True), ("one_stage", 0.75, False),
                                            ("lane_static", 1.0, True)])
def test_batched_depth_k_is_depth_1_bit_for_bit_on_card(dev, tf32_default, name, scale, pad):
    from repro_torch.batched import BatchedPerceptionEngine

    frames = _scene_images(12)
    results = {}
    for depth in (1, 2, 3):
        eng = BatchedPerceptionEngine(name, capacity=3, scale=scale, pad=pad, depth=depth,
                                      device=dev)
        for s in range(3):
            eng.join(f"cam{s}")
        seq = []
        for t in range(4):
            _, outs = eng.tick({f"cam{s}": frames[3 * t + s] for s in range(3)})
            seq += [outs[k] for k in sorted(outs)]
        for _, outs, _ in eng.flush():
            seq += [outs[k] for k in sorted(outs)]
        results[depth] = seq
        assert eng.trace_count == 1 and eng.replay_count == 4
    for depth in (2, 3):
        assert len(results[depth]) == len(results[1]) == 12
        for a, b in zip(results[depth], results[1]):
            assert (a.num_objects, a.num_proposals) == (b.num_objects, b.num_proposals)
            assert np.array_equal(a.boxes, b.boxes)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
def test_staging_ring_is_never_overwritten_early(dev, tf32_default, depth):
    """2 x depth submits of distinct frames with no drain in between: the
    staging ring wraps while its copies may still be pending, and the
    output ring grows past depth; every drained result must still be its
    own frame's, as the serial pipeline gives it."""
    from repro_torch.batched import PipelinedExecutor
    from repro_torch.perception import build_pipeline, run_frame
    from repro_torch.perception.data import Scene

    built = build_pipeline("one_stage", device=dev)
    frames = _scene_images(2 * depth * 2, seed0=80)
    ex = PipelinedExecutor(built.device_step, 2, frames[0].shape, depth=depth, device=dev)
    for t in range(2 * depth):
        ex.submit({0: frames[2 * t], 1: frames[2 * t + 1]}, payload=t)
    drained = ex.flush()
    assert [d.payload for d in drained] == list(range(2 * depth))
    for t, d in enumerate(drained):
        host = [np.array(a) for a in d.host]
        for slot in range(2):
            boxes, _, keep = (a[slot] for a in host)
            scene = Scene(image=frames[2 * t + slot], boxes=np.zeros((0, 4), np.float32),
                          lane_pixels=np.zeros((0, 2), np.int64), scenario="city", rain=0.0)
            _, want = run_frame(built, scene)
            assert int(keep.sum()) == want.num_objects
            np.testing.assert_allclose(boxes[keep], want.boxes, atol=1e-3, rtol=0)
    assert ex.step_captures == 1 and ex.step_replays == 2 * depth


@pytest.mark.cuda
def test_capture_failure_raises_and_runs_nothing_eagerly(dev):
    """A step with a host-to-device copy from pageable memory inside cannot
    be captured: the executor raises and never runs the step on its own."""
    from repro_torch.batched import PipelinedExecutor
    from repro_torch.batched.executor import WARMUP_RUNS

    calls = []

    def step(raw):
        calls.append(torch.cuda.is_current_stream_capturing())
        return raw.sum(dim=(1, 2, 3)) + torch.from_numpy(np.ones(2, np.float32)).to(raw.device)

    ex = PipelinedExecutor(step, 2, (4, 4, 3), device=dev)
    with pytest.raises(RuntimeError, match="could not be captured"):
        ex.submit({0: np.ones((4, 4, 3), np.float32)})
    assert ex.step_captures == 0 and ex.step_replays == 0 and ex.pending == 0
    # the warm-up runs before the capture, then the capture attempt: no run after
    assert calls == [False] * WARMUP_RUNS + [True]
    torch.cuda.synchronize()
    assert float(torch.ones(2, device=dev).sum()) == 2.0    # the context still works


# ------------------------------------------------------- scenario replay --
# Replay runs the batched perception graphs (none of the kernels above).
# On the card it is held against its own CPU replay on the same seed-7
# weights (tests/test_torch_scenarios.py holds the CPU replay against JAX):
# every count, rung histogram and modeled latency equal, mean_quality
# within 5e-4 (the bound a 1e-3 px box difference puts on an IoU of boxes
# 8 px or larger).

def _exact_but_quality():
    from repro_torch.scenarios import Tolerance

    return Tolerance(rel=0.0, abs_ms=0.0, rate=0.0, quality=5e-4, count_frac=0.0, count_abs=0)


@pytest.mark.cuda
def test_scenario_replay_on_card_equals_cpu(dev, tf32_default):
    from repro_torch.scenarios import compare_reports, golden_replay
    from repro_torch.scenarios.golden import GOLDEN_EPISODES

    reports, scheds, sentinels = {}, {}, []
    for d in (dev, "cpu"):
        sched = None
        for name in GOLDEN_EPISODES:
            # the tick loop (after the warm-up's captures): no build, no host sync
            sent = TraceSentinel(compile_budget=0) if d is dev else None
            rep, sched = golden_replay(name, scheduler=sched, device=None if sched else d,
                                       sentinel=sent)
            reports[(str(d), name)] = rep.to_dict()
            sentinels += [sent] if sent is not None else []
        scheds[str(d)] = sched
    assert [s.report().compiles for s in sentinels] == [0] * len(GOLDEN_EPISODES)
    for name in GOLDEN_EPISODES:
        got, want = reports[(str(dev), name)], reports[("cpu", name)]
        assert compare_reports(got, want, _exact_but_quality()) == []
        assert got["totals"] == want["totals"] and got["clock_s"] == want["clock_s"]
    # one capture per rung engine across both episodes
    assert [e.executor.step_captures for e in scheds[str(dev)].engines.values()] == [1, 1, 1]


@pytest.mark.cuda
def test_chaos_storm_on_card_equals_cpu(dev, tf32_default):
    """sensor_stall_storm on the card against the CPU: the same report (as
    above) and the same ledger event for event, the tick loop free of host
    syncs, and one capture per rung engine through the storm: corrupt
    frames are dropped on the host, stalled and aborted buckets only skip
    a tick."""
    from repro_torch.chaos import run_chaos_episode
    from repro_torch.scenarios import compare_reports

    sent = TraceSentinel(compile_budget=0)
    card, card_replayer, _ = run_chaos_episode("sensor_stall_storm", sentinel=sent,
                                               device=str(dev))
    assert sent.report().compiles == 0
    cpu, cpu_replayer, _ = run_chaos_episode("sensor_stall_storm", device="cpu")
    got, want = card.to_dict(), cpu.to_dict()
    assert compare_reports(got, want, _exact_but_quality()) == []
    assert got["chaos"] == want["chaos"] and got["chaos"]["counts"]["nan_drop"] >= 1
    assert [e.executor.step_captures for e in card_replayer.scheduler.engines.values()] == \
        [1, 1, 1]


# ------------------------------------------------------ two-shard fleet --
# Two shards on one card (a mesh naming the device twice): each shard's block
# of the slot batch is captured in its own graph (at batch capacity/2) and
# replayed on its own stream.  cuDNN may choose other algorithms at batch 4
# than at 8, so per-slot outputs are held against one shard in the batched
# phase's bands (counts equal, boxes within 1e-3 px), not bit for bit.

@contextlib.contextmanager
def _no_sync_captures(sched, at, sent):
    """A replay sentinel: the tick loop under ``sent`` (a TraceSentinel),
    each engine's captures read as it starts and as it ends."""
    at.append([e.executor.step_captures for e in sched.engines.values()])
    try:
        with sent:
            yield
    finally:
        at.append([e.executor.step_captures for e in sched.engines.values()])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["two_stage", "one_stage", "lane_static"])
@pytest.mark.parametrize("depth", [1, 2])
def test_two_shards_on_one_card_match_one_shard(dev, tf32_default, name, depth):
    from repro_torch.batched import BatchedPerceptionEngine
    from repro_torch.launch.mesh import make_local_mesh

    frames = _scene_images(18, seed0=90)
    results = {}
    for shards, d in ((1, 1), (2, depth)):
        eng = BatchedPerceptionEngine(name, capacity=8, depth=d, device=dev,
                                      mesh=make_local_mesh(data=shards, devices=[dev] * shards))
        for s in range(6):
            eng.join(f"cam{s}")
        eng.probe(frames[:8])          # builds the steps and the post's host copies
        seq = []
        with TraceSentinel(compile_budget=0, transfer_guard="disallow") as sent:
            for t in range(3):
                _, outs = eng.tick({f"cam{s}": frames[6 * t + s] for s in range(6)})
                seq += [outs[k] for k in sorted(outs)]
            for _, outs, _ in eng.flush():
                seq += [outs[k] for k in sorted(outs)]
        assert sent.report().compiles == 0
        assert eng.trace_count == shards and eng.replay_count == 4 * shards
        if shards == 2:
            assert eng.shard_occupancy() == [3, 3]
        results[shards] = seq
    assert len(results[1]) == len(results[2]) == 18
    for a, b in zip(results[2], results[1]):
        assert (a.num_objects, a.num_proposals) == (b.num_objects, b.num_proposals)
        assert a.boxes.shape == b.boxes.shape
        if a.boxes.size:
            assert float(np.abs(a.boxes - b.boxes).max()) <= 1e-3


@pytest.mark.cuda
def test_shard_loss_at_two_shards_on_card_equals_cpu(dev, tf32_default):
    """shard_loss_rush_hour at two shards on one card against two CPU
    shards: the same report (exact but mean_quality) and ledger, the tick
    loop free of host syncs, and two captures per engine (one per shard)
    by the warm-up with none added through the kill, the failover, the
    revive and the rebalance."""
    from repro_torch.batched import RungBucketScheduler
    from repro_torch.chaos import CHAOS_CATALOG, run_chaos_episode
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.scenarios import compare_reports, replay_ladder

    sched = RungBucketScheduler(replay_ladder(), capacity=CHAOS_CATALOG[
        "shard_loss_rush_hour"].capacity, device=dev,
        mesh=make_local_mesh(data=2, devices=[dev, dev]))
    at, sent = [], TraceSentinel(compile_budget=0)
    card, card_rep, _ = run_chaos_episode("shard_loss_rush_hour", scheduler=sched,
                                          sentinel=_no_sync_captures(sched, at, sent))
    cpu, cpu_rep, _ = run_chaos_episode("shard_loss_rush_hour", device="cpu",
                                        mesh=make_local_mesh(data=2, devices=["cpu", "cpu"]))
    got, want = card.to_dict(), cpu.to_dict()
    assert compare_reports(got, want, _exact_but_quality()) == []
    assert got["chaos"] == want["chaos"] and got["chaos"]["counts"]["failover"] >= 1
    assert card_rep.injector.ledger.reseat_ticks() <= 3
    assert at == [[2, 2, 2], [2, 2, 2]]
    assert sent.report().compiles == 0
    assert {n: e.shard_occupancy() for n, e in card_rep.scheduler.engines.items()} == \
        {n: e.shard_occupancy() for n, e in cpu_rep.scheduler.engines.items()}


@pytest.mark.cuda
def test_shards_on_distinct_cards_match_one_card(dev, tf32_default):
    """Where the machine has two cards or more, a mesh over every visible
    card (``make_local_mesh(data=n)``) puts each shard's block, its copy of
    the weights and its graph on its own card; outputs match one shard on
    one card in the bands above, and shard_loss_rush_hour over two cards
    equals two CPU shards."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices or more")
    from repro_torch.batched import BatchedPerceptionEngine
    from repro_torch.chaos import run_chaos_episode
    from repro_torch.launch.mesh import make_local_mesh

    data = 4 if n >= 4 else 2
    mesh = make_local_mesh(data=data)
    assert [str(d) for d in mesh.devices[:, 0]] == [f"cuda:{k}" for k in range(data)]
    frames = _scene_images(16, seed0=120)
    results = {}
    for m in (None, mesh):
        eng = BatchedPerceptionEngine("two_stage", capacity=8, device=dev, mesh=m)
        for s in range(8):
            eng.join(f"cam{s}")
        eng.probe(frames[:8])
        seq = []
        for t in range(2):
            _, outs = eng.tick({f"cam{s}": frames[8 * t + s] for s in range(8)})
            seq += [outs[k] for k in sorted(outs)]
        results[m is None] = seq
        assert eng.trace_count == eng.executor.n_shards
    assert [sh.device.index for sh in eng.executor._shards] == list(range(data))
    for a, b in zip(results[False], results[True]):
        assert (a.num_objects, a.num_proposals) == (b.num_objects, b.num_proposals)
        if a.boxes.size:
            assert float(np.abs(a.boxes - b.boxes).max()) <= 1e-3
    card, _, _ = run_chaos_episode("shard_loss_rush_hour", device=dev,
                                   mesh=make_local_mesh(data=2, devices=["cuda:0", "cuda:1"]))
    cpu, _, _ = run_chaos_episode("shard_loss_rush_hour", device="cpu",
                                  mesh=make_local_mesh(data=2, devices=["cpu", "cpu"]))
    assert card.to_dict()["chaos"] == cpu.to_dict()["chaos"]
    assert card.totals() == cpu.totals()


# ----------------------------------------------------- multi-tenant serving --
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-3b"])
def test_multi_tenant_smoke_tokens_on_card_equal_cpu(dev, arch):
    """The same queued AlwaysAdmit workload, f32 smoke weights: every
    tenant's generated tokens, slots and ramp steps equal on the card and
    the CPU; qwen3-4b launches decode_attention once per layer a step."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.runtime import (AlwaysAdmit, MultiTenantConfig, MultiTenantEngine,
                                     RequestQueue, poisson_workload)

    model = Model(get_config(arch, smoke=True))
    p_cpu = model.init(seed=1, device="cpu")
    out = {}
    for d, params in (("cpu", p_cpu), (dev, _to(p_cpu, dev))):
        eng = MultiTenantEngine(model, params, MultiTenantConfig(3, 64), admission=AlwaysAdmit(),
                                device=d)
        q = RequestQueue()
        for r in poisson_workload(7, 100.0, model.cfg.vocab_size, prompt_len=8,
                                  max_new_tokens=12, seed=2):
            q.push(r)
        eng.compile()
        K.reset_launch_counts()
        steps = eng.drain(q)
        counts = K.launch_counts()
        out[str(d)] = (steps, [(t.req.tenant, t.slot, t.generated, t.ramp_steps)
                               for t in eng.finished])
        assert eng.trace_count == 1
    assert out[str(dev)] == out["cpu"]
    attn = model.n_attn_sites()
    assert counts["decode_attention"] == out["cpu"][0] * attn


# ------------------------------------------------ moe, vlm and audio paths --
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internvl2-1b", "hubert-xlarge"])
def test_frontend_model_cuda_path_matches_cpu_path(dev, arch):
    """The VLM (patch embeddings, then text) and the audio encoder (frames,
    non-causal) smoke models through the kernels against the plain
    versions; 1e-3 as for the token archs."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    model = Model(get_config(arch, smoke=True))
    cfg = model.cfg
    p_cpu = model.init(seed=1, device="cpu")
    rng = np.random.default_rng(2)
    batch = {}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((2, 64, cfg.frontend_dim)).astype(np.float32)
    else:
        p = cfg.frontend_tokens
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (2, 64 - p)).astype(np.int32)
        batch["patch_embeds"] = rng.standard_normal((2, p, cfg.frontend_dim)).astype(np.float32)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        want, _ = model.forward(p_cpu, batch)
        got, _ = model.forward(_to(p_cpu, dev), _to(batch, dev))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
def test_moe_layer_full_width_on_card_matches_cpu(dev):
    """One olmoe-1b-7b MoE layer at full width (64 experts top-8, d 2048,
    d_ff 1024, one group of 512 tokens, capacity 80) in bf16 on the card
    and on the CPU from the same weights.  Each device rounds a router logit
    to bf16 once, so the two logits of an expert differ by at most one ulp
    of the token's largest logit: where a token's 8th and 9th logits differ
    by more than two such ulps, its experts are equal; a token with equal experts and
    kept choices has an equal output within 1e-2 of the largest output
    (bf16 rounding of products summed in different orders)."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_block, moe_specs, route
    from repro_torch.models.params import init_params

    cfg = get_config("olmoe-1b-7b")
    gen = torch.Generator().manual_seed(0)
    p_cpu = init_params(moe_specs(cfg), gen, torch.bfloat16, "cpu")
    x = torch.randn((1, 512, cfg.d_model), generator=gen).to(torch.bfloat16)
    with torch.inference_mode():
        want, aux_c = moe_block(p_cpu, x, cfg)
        got, aux_g = moe_block(_to(p_cpu, dev), x.to(dev), cfg)
        r_c = route(p_cpu["router"], x, cfg)
        r_g = route(p_cpu["router"].to(dev), x.to(dev), cfg)
    k = cfg.num_experts_per_tok
    srt = r_c.logits.sort(-1, descending=True).values[0]
    ulp = 2.0 ** (torch.floor(torch.log2(srt.abs().amax(-1))) - 7)
    clear = (srt[:, k - 1] - srt[:, k]) > 2 * ulp
    ids_c = r_c.top_ids[0].sort(-1).values
    ids_g = r_g.top_ids[0].cpu().sort(-1).values
    same_ids = (ids_c == ids_g).all(-1)
    assert clear.float().mean() > 0.25
    assert same_ids[clear].all()
    same = same_ids & (r_c.keep[0] == r_g.keep[0].cpu()).all(-1) & \
        (r_c.top_ids[0] == r_g.top_ids[0].cpu()).all(-1)
    assert same.float().mean() > 0.25
    err = (got[0].cpu().float() - want[0].float())[same].abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item()
    for name in aux_c:
        assert torch.isfinite(aux_g[name]).all()
    assert abs(aux_g["drop_fraction"].item() - aux_c["drop_fraction"].item()) <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,k,d,causal,window", [
    (4, 1024, 16, 16, 80, False, None),     # hubert-xlarge: non-causal, head_dim 80
    (1, 8192, 48, 8, 128, True, 4096),      # mixtral-8x22b: a 4096 window over 8192
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_at_new_full_width_shapes(dev, b, s, h, k, d, causal, window, dtype):
    q, kk, v = _randn(dev, dtype, 8, (b, s, h, d), (b, s, k, d), (b, s, k, d))
    got = K.flash_attention(q, kk, v, causal=causal, window=window)
    _close(got, R.flash_attention_ref(*_f32(q, kk, v), causal, window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [96, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_at_internvl2_shape(dev, fill, dtype):
    """internvl2-1b's decode: 14 query heads over 2 KV heads (a group of 7,
    so the kernel takes one head a block and reads the cache 7 times)."""
    b, h, k, d, c = 4, 14, 2, 64, 1024
    q, kc, vc = _randn(dev, dtype, 9, (b, h, d), (b, c, k, d), (b, c, k, d))
    pos = torch.where(torch.arange(c) < fill, torch.arange(c), -1).to(torch.int32).to(dev)
    npos = torch.tensor(fill - 1, dtype=torch.int32, device=dev)
    _close(K.decode_attention(q, kc, vc, pos, npos),
           R.decode_attention_ref(*_f32(q, kc, vc), pos, npos), dtype)


# -------------------------------------------------------------- training --
# The flash backward kernel against its plain version (f32 formulas) on the
# same inputs: o and the rows' log-sum-exp are the forward kernel's, dO
# standard normal, in the working dtype.  Tolerance: the f32 band above (summation order) and,
# for bf16, the same band plus the one rounding of dq, dk and dv to bf16
# (TOL, as the forward's: both compute in f32 from the same bf16 inputs).
FLASH_BWD_SHAPES = [(1, 128, 4, 4, 32, True, None), (2, 200, 8, 2, 64, True, 96),
                    (1, 100, 4, 1, 16, False, None), (2, 256, 4, 2, 80, False, 96),
                    (2, 1024, 32, 8, 128, True, None),      # qwen3-4b's training shape
                    (4, 1024, 16, 16, 80, False, None),     # hubert-xlarge, non-causal
                    (1, 8192, 48, 8, 128, True, 4096),      # mixtral-8x22b's window
                    (4, 1024, 14, 2, 64, True, None)]       # internvl2-1b, G = 7


def _fwd_with_lse(q, kk, v, causal, window):
    b, s, h, _ = q.shape
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    return flash_attention_cuda(q, kk, v, causal=causal, window=window, lse=lse), lse


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,k,d,causal,window", FLASH_BWD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_matches_plain(dev, b, s, h, k, d, causal, window, dtype):
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda

    q, kk, v, do = _randn(dev, dtype, 10, (b, s, h, d), (b, s, k, d), (b, s, k, d), (b, s, h, d))
    o, lse = _fwd_with_lse(q, kk, v, causal, window)
    n0 = flash_attention_bwd_cuda.launches
    got = flash_attention_bwd_cuda(q, kk, v, o, do, lse, causal, window)
    torch.cuda.synchronize()
    assert flash_attention_bwd_cuda.launches == n0 + 1
    want = R.flash_attention_bwd_ref(*_f32(q, kk, v, o, do), causal, window)
    for g, w in zip(got, want):
        assert g.dtype == q.dtype and g.shape == w.shape
        _close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,k,d,causal,window", FLASH_BWD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_output_same_bits_with_and_without_lse(dev, b, s, h, k, d, causal, window, dtype):
    """Asking the forward for the rows' log-sum-exp writes only that: its
    output is bit for bit the output of the call without the buffer."""
    q, kk, v = _randn(dev, dtype, 11, (b, s, h, d), (b, s, k, d), (b, s, k, d))
    with_lse, _ = _fwd_with_lse(q, kk, v, causal, window)
    assert torch.equal(with_lse, flash_attention_cuda(q, kk, v, causal=causal, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,k,d,causal,window", FLASH_BWD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_lse_matches_plain(dev, b, s, h, k, d, causal, window, dtype):
    """The forward's lse (f32 in both dtypes: the scores of the same inputs
    summed in f32) against the plain logsumexp at the f32 band."""
    q, kk, v = _randn(dev, dtype, 12, (b, s, h, d), (b, s, k, d), (b, s, k, d))
    _, lse = _fwd_with_lse(q, kk, v, causal, window)
    want = R.flash_attention_lse_ref(*_f32(q, kk), causal, window)
    assert lse.shape == want.shape == (b, h, s)
    _close(lse, want, "float32")


def _leaves(params):
    from repro_torch.train.optimizer import _walk
    return [p for _, p in _walk(params)]


def _train_launches(model) -> dict:
    """The kernels' launches in one forward and backward of ``model.loss``:
    per attention site the flash forward (twice with remat: the forward and
    the recomputation) and its backward kernel once; per RWKV6 or Mamba2
    layer its scan's forward kernel (twice with remat) and its backward
    kernel once."""
    cfg = model.cfg
    fwd = 2 if cfg.remat else 1
    sites = model.n_attn_sites()
    ssm, hybrid = cfg.family == "ssm", cfg.family == "hybrid"
    return {"flash_attention": fwd * sites, "flash_attention_bwd": sites, "decode_attention": 0,
            "rwkv6_wkv": fwd * cfg.num_layers if ssm else 0,
            "rwkv6_wkv_bwd": cfg.num_layers if ssm else 0,
            "mamba2_ssd": fwd * cfg.num_layers if hybrid else 0,
            "mamba2_ssd_bwd": cfg.num_layers if hybrid else 0}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "olmoe-1b-7b", "internvl2-1b", "hubert-xlarge",
                                  "rwkv6-3b", "zamba2-2.7b"])
def test_loss_gradients_on_card_match_cpu(dev, arch):
    """Model.loss and every gradient leaf of the smoke model (f32) through
    the kernels (flash forward and backward; the scans' forward and
    backward kernels) against the plain versions on the CPU,
    which tests/test_torch_train.py holds against JAX.  Loss 1e-5
    relative; gradients 1e-3 of each leaf's largest magnitude and 1e-3
    relative (cuBLAS and the CPU sum in different orders, as the prefill's
    1e-3 above); every leaf's gradient nonzero on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import DataConfig, make_batch_np

    model = Model(get_config(arch, smoke=True))
    p_cpu = model.init(seed=1, device="cpu")
    p_gpu = _to(p_cpu, dev)
    batch = make_batch_np(model.cfg, DataConfig(2, 64), 0)
    out = {}
    for d, params in (("cpu", p_cpu), ("gpu", p_gpu)):
        leaves = [p.requires_grad_() for p in _leaves(params)]
        K.reset_launch_counts()
        loss, _ = model.loss(params, {k: torch.from_numpy(v).to(d if d == "cpu" else dev)
                                      for k, v in batch.items()})
        grads = torch.autograd.grad(loss, leaves)
        out[d] = (loss.item(), [g.cpu() for g in grads], K.launch_counts())
    assert not any(out["cpu"][2].values())
    assert out["gpu"][2] == _train_launches(model)
    np.testing.assert_allclose(out["gpu"][0], out["cpu"][0], rtol=1e-5)
    for g, w in zip(out["gpu"][1], out["cpu"][1]):
        assert g.abs().max() > 0
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3,
                                   atol=1e-3 * max(w.abs().max().item(), 1e-30))


@pytest.mark.cuda
def test_decode_raises_and_the_scans_train_under_grad(dev):
    """Under grad on the card decode attention raises rather than hand
    autograd an output cut from its inputs; the scans launch their forward
    kernels (y equal to the launch without grad, bit for bit) and their
    backward kernels, and return a gradient for every input, held against
    the same Functions on the CPU (the step recurrences forward, the
    chunked forms' gradients, which tests/test_torch_scan_grad.py holds
    against JAX) at 1e-4 of each input's largest gradient."""
    def check(op, name, ins, **kw):
        cuda_in = [x.to(dev).requires_grad_() for x in ins]
        cpu_in = [x.clone().requires_grad_() for x in ins]
        n0 = K.launch_counts()[name]
        y = op(*cuda_in, **kw)
        assert K.launch_counts()[name] == n0 + 1 and y.grad_fn is not None
        with torch.no_grad():
            assert torch.equal(y, op(*cuda_in, **kw))
        dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(3))
        b0 = K.launch_counts()[f"{name}_bwd"]
        got = torch.autograd.grad(y, cuda_in, dy.to(dev))
        assert K.launch_counts()[f"{name}_bwd"] == b0 + 1
        torch.cuda.synchronize()
        want = torch.autograd.grad(op(*cpu_in, **kw), cpu_in, dy)
        for g, w in zip(got, want):
            assert g is not None and g.abs().max() > 0
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-4 * w.abs().max().item())

    cpu = torch.device("cpu")
    r, k2, v2, w = _randn(cpu, "float32", 11, *[(2, 128, 2, 16)] * 4)
    u, = _randn(cpu, "float32", 14, (2, 16))
    check(K.rwkv6_wkv, "rwkv6_wkv", [r, k2, v2, -torch.nn.functional.softplus(w), u],
          chunk=32, grad_chunk=64)
    x, bm, cm = _randn(cpu, "float32", 12, (2, 128, 4, 16), (2, 128, 16), (2, 128, 16))
    dt = torch.nn.functional.softplus(_randn(cpu, "float32", 15, (2, 128, 4))[0])
    check(K.mamba2_ssd, "mamba2_ssd", [x, dt, -torch.ones(4), bm, cm], chunk=32, head_block=4)
    q, kc, vc = _randn(dev, "float32", 13, (2, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32))
    pos = torch.arange(64, dtype=torch.int32, device=dev)
    npos = torch.tensor(63, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="decode_attention has no backward"):
        K.decode_attention(q.requires_grad_(), kc, vc, pos, npos)
    with torch.no_grad():
        K.decode_attention(q, kc, vc, pos, npos)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [True, False])
def test_flash_launches_per_train_step(dev, remat):
    """A train step launches the flash forward L times and, with remat,
    L more in the recomputation; the backward kernel L times."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import AdamWConfig, DataConfig, make_batch_np, make_train_step
    from repro_torch.train.data import to_device
    from repro_torch.train.optimizer import adamw_init

    model = Model(get_config("qwen3-4b", smoke=True).replace(num_layers=3, remat=remat))
    params = model.init(seed=2, device=dev)
    for p in _leaves(params):
        p.requires_grad_()
    step = make_train_step(model, AdamWConfig())
    batch = to_device(make_batch_np(model.cfg, DataConfig(2, 128), 0), dev)
    K.reset_launch_counts()
    _, _, metrics = step(params, adamw_init(params), batch)
    torch.cuda.synchronize()
    L = model.cfg.num_layers
    assert K.launch_counts() == {"flash_attention": (2 if remat else 1) * L,
                                 "flash_attention_bwd": L, "decode_attention": 0,
                                 "rwkv6_wkv": 0, "rwkv6_wkv_bwd": 0, "mamba2_ssd": 0,
                                 "mamba2_ssd_bwd": 0} == _train_launches(model)
    assert torch.isfinite(metrics["loss"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers", [("rwkv6-3b", 3), ("zamba2-2.7b", 4)])
@pytest.mark.parametrize("remat", [True, False])
def test_scan_launches_per_train_step(dev, arch, layers, remat):
    """A train step of the scan families: rwkv6-3b launches its WKV kernel
    L times and, with remat, L more in the recomputation; zamba2-2.7b its
    SSD kernel likewise per Mamba2 layer, and per site of the shared block
    (one each 2 layers at smoke size, remat per site) the flash forward once
    or twice and the backward kernel once.  The scans' backward kernels
    launch once a layer.  Every gradient leaf is finite and some nonzero."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import DataConfig, make_batch_np
    from repro_torch.train.data import to_device

    model = Model(get_config(arch, smoke=True).replace(num_layers=layers, remat=remat))
    params = model.init(seed=2, device=dev)
    leaves = [p.requires_grad_() for p in _leaves(params)]
    batch = to_device(make_batch_np(model.cfg, DataConfig(2, 128), 0), dev)
    K.reset_launch_counts()
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    want = _train_launches(model)
    assert K.launch_counts() == want
    scan = "rwkv6_wkv" if arch == "rwkv6-3b" else "mamba2_ssd"
    assert want[scan] == (2 if remat else 1) * layers and want[f"{scan}_bwd"] == layers
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
    assert all(g.abs().max() > 0 for g in grads)


# ------------------------------------------- the static certifier on the card

@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2])
def test_cert_sweep_captures_once_per_shard_on_the_card(dev, shards):
    """The envelope's occupancy and churn sweep through a real engine on the
    card (its step captured and replayed behind a signature recorder): one
    capture per shard, no new signature after warmup."""
    from repro_torch.analysis.cert import InputEnvelope, RungPoint, certify_rung
    from repro_torch.perception.data import H, W

    env = InputEnvelope(capacity=4, occupancies=(1, 2, 3, 4), batch_sizes=(1,),
                        image_shape=(H, W, 3), rungs=(RungPoint("early_exit", "early_exit"),),
                        ladder_rungs=(), kernels=(), fleet_shards=(shards,))
    trace = certify_rung(env.rungs[0], env, shards=shards, device="cuda:0", execute=True)
    (prog,) = trace.programs.values()
    assert trace.violations == [] and trace.step_captures == shards
    assert prog.signatures == [f"(f32[{4 // shards},96,320,3])"]


@pytest.mark.cuda
def test_cert_floors_stay_below_the_card_s_step(dev):
    """Each (rung, batch size) step measured on the card is at or above its
    static floor on the H100 model."""
    from repro_torch.analysis.cert import InputEnvelope, RungPoint, measure_steps
    from repro_torch.analysis.cert.certificate import _cost_row
    from repro_torch.analysis.cert.roofline import H100_SXM
    from repro_torch.perception.data import H, W

    env = InputEnvelope(capacity=2, occupancies=(1, 2), batch_sizes=(1, 2),
                        image_shape=(H, W, 3), rungs=(RungPoint("one_stage", "one_stage"),),
                        ladder_rungs=(), kernels=())
    torch.backends.cudnn.allow_tf32 = True
    try:
        bench = measure_steps(env, "cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    for b in env.batch_sizes:
        row = _cost_row(env.rungs[0], b, env, H100_SXM)
        assert 0.0 < row["floor_s"] <= bench[("one_stage", b)]


@pytest.mark.cuda
def test_counting_hook_never_stands_in_for_a_launch(dev):
    """Under the counter's hook a CUDA tensor raises; without it the entry
    point launches its kernel and counts the launch, as before."""
    from repro_torch.analysis.cert.costs import Counts, counting

    q = torch.randn(1, 128, 4, 32, device="cuda")
    K.reset_launch_counts()
    with counting(Counts()):
        with pytest.raises(RuntimeError, match="real tensor"):
            K.flash_attention(q, q, q)
    assert K.launch_counts()["flash_attention"] == 0
    K.flash_attention(q, q, q)
    assert K.launch_counts()["flash_attention"] == 1


# ------------------------------------------------------ trace sentinel --
# The sentinel's guard on the card: transfer_guard "disallow" is
# torch.cuda.set_sync_debug_mode("error") over the region, restored on exit.

@pytest.mark.cuda
@pytest.mark.parametrize("what", ["item", "pageable_as_tensor"])
def test_sentinel_disallow_raises_on_a_host_sync(dev, what):
    x = torch.ones(4, device=dev)
    with pytest.raises(RuntimeError):
        with TraceSentinel(compile_budget=0, transfer_guard="disallow"):
            if what == "item":
                x.sum().item()
            else:
                torch.as_tensor(np.ones(4, np.float32), device=dev)
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_sentinel_disallow_passes_a_pinned_copy_and_allow_passes_item(dev):
    pinned = torch.ones(1024, pin_memory=True)
    with TraceSentinel(compile_budget=0, transfer_guard="disallow") as sent:
        dst = torch.empty(pinned.shape, device=dev)
        dst.copy_(pinned, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
    assert sent.report().ok and torch.cuda.get_sync_debug_mode() == 0
    with TraceSentinel(compile_budget=0, transfer_guard="allow"):
        assert dst.sum().item() == 1024.0
    # nested: the inner level holds inside, the outer one is restored after
    with TraceSentinel(compile_budget=0, transfer_guard="disallow"):
        with TraceSentinel(compile_budget=0, transfer_guard="allow"):
            dst.sum().item()
        assert torch.cuda.get_sync_debug_mode() == 2
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_sentinel_counts_a_fresh_capture(dev, tf32_default):
    from repro_torch.batched import BatchedPerceptionEngine

    eng = BatchedPerceptionEngine("early_exit", capacity=4, device=dev)
    sent = TraceSentinel(compile_budget=0, transfer_guard="allow")
    with pytest.raises(TimingHazardError):
        with sent:
            eng.executor.warmup()
    assert sent.report().compiles == eng.executor.step_captures == 1
    assert sent.report().traces == 4          # WARMUP_RUNS eager runs and the capture's
