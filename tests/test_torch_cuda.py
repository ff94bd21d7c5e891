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
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels.decode_attention import MAX_SPLITS, decode_attention_cuda, \
    splits_for  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.mamba2_ssd import mamba2_ssd_cuda  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_wkv_cuda  # noqa: E402

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


@pytest.mark.cuda
@pytest.mark.parametrize("arch,seq", [("qwen3-4b", 64), ("rwkv6-3b", 64), ("zamba2-2.7b", 64)])
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
