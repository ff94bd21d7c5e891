"""The port's attention kernels against the reference's Pallas kernels.

CPU arms: the port's plain versions (``repro_torch.kernels.ref``, which the
wrappers use for CPU tensors) against the JAX Pallas kernels run as
``tests/test_kernels.py`` runs them (``interpret=True``), over that file's
flash and decode sweeps plus head_dim 80 (zamba2's shared block) and the
ring-buffer wraparound, on the same inputs made with numpy.  Tolerance: f32 2e-5 absolute and relative, the reference
sweep's own (``test_kernels.py:23``); both sides accumulate in f32 in a
different order.

The hand-written kernels themselves are held against the plain versions
on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.decode_attention import decode_attention_fwd  # noqa: E402
from repro.kernels.flash_attention import flash_attention_fwd  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda, \
    num_splits  # noqa: E402
from repro_torch.kernels.flash_attention import check_attention_inputs, \
    flash_attention_cuda  # noqa: E402

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=5e-2, rtol=5e-2)

FLASH_SHAPES = [
    (1, 128, 4, 4, 32),    # MHA
    (2, 256, 4, 2, 32),    # GQA
    (1, 128, 8, 1, 64),    # MQA
    (1, 128, 4, 4, 80),    # MHA at zamba2's head_dim
]
DECODE_SHAPES = [
    (2, 4, 2, 32, 256),
    (1, 8, 1, 64, 128),   # MQA
    (2, 4, 4, 32, 128),   # MHA
    (2, 4, 4, 80, 128),   # MHA at zamba2's head_dim
]


def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _decode_inputs(b, h, k, d, c, fill, seed=3):
    q, kc, vc = _randn(seed, (b, h, d), (b, c, k, d), (b, c, k, d))
    positions = np.where(np.arange(c) < fill, np.arange(c), -1).astype(np.int32)
    return q, kc, vc, positions, np.int32(fill - 1)


def _wrapped_inputs(c=64):
    """The wraparound case of test_kernels.py: slot i < 10 holds i + c."""
    q, kc, vc = _randn(6, (1, 2, 16), (1, c, 2, 16), (1, c, 2, 16))
    positions = np.where(np.arange(c) < 10, np.arange(c) + c, np.arange(c)).astype(np.int32)
    return q, kc, vc, positions, np.int32(c + 9)


def _t(*arrays, device="cpu", dtype=None):
    out = [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]
    if dtype is not None:
        out = [t.to(dtype) if t.is_floating_point() else t for t in out]
    return out


# ------------------------------------------------- CPU: plain vs Pallas ----
@pytest.mark.parametrize("b,s,h,k,d", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 96])
def test_flash_ref_matches_pallas(b, s, h, k, d, causal, window):
    q, kk, v = _randn(0, (b, s, h, d), (b, s, k, d), (b, s, k, d))
    want = flash_attention_fwd(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(v),
                               causal=causal, window=window,
                               block_q=64, block_kv=64, interpret=True)
    got = K.flash_attention(*_t(q, kk, v), causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("b,h,k,d,c", DECODE_SHAPES)
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("fill", [16, 100])
def test_decode_ref_matches_pallas(b, h, k, d, c, window, fill):
    q, kc, vc, pos, npos = _decode_inputs(b, h, k, d, c, fill)
    want = decode_attention_fwd(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(pos), jnp.asarray(npos),
                                window=window, block_kv=64, interpret=True)
    got = K.decode_attention(*_t(q, kc, vc, pos, npos), window=window)
    assert got.shape == (b, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_decode_ref_ring_buffer_wraparound_matches_pallas():
    q, kc, vc, pos, npos = _wrapped_inputs()
    c = kc.shape[1]
    want = decode_attention_fwd(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(pos), jnp.asarray(npos),
                                window=c, block_kv=32, interpret=True)
    got = K.decode_attention(*_t(q, kc, vc, pos, npos), window=c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_cpu_dispatch_counts_no_launch():
    K.reset_launch_counts()
    q, kk, v = _randn(1, (1, 64, 2, 32), (1, 64, 1, 32), (1, 64, 1, 32))
    K.flash_attention(*_t(q, kk, v))
    assert K.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                 "rwkv6_wkv": 0, "mamba2_ssd": 0}


# ------------------------------------------------------ wrapper checks ----
@pytest.mark.parametrize("case", ["head_dim", "heads", "dtype", "mixed", "strided", "window"])
def test_wrapper_input_checks_raise(case):
    q = torch.zeros(1, 64, 4, 32)
    k = torch.zeros(1, 64, 2, 32)
    kw = {}
    if case == "head_dim":
        q, k = torch.zeros(1, 64, 4, 48), torch.zeros(1, 64, 2, 48)
    elif case == "heads":
        k = torch.zeros(1, 64, 3, 32)
    elif case == "dtype":
        q, k = q.half(), k.half()
    elif case == "mixed":
        k = k.bfloat16()
    elif case == "strided":
        q = torch.zeros(1, 4, 64, 32).transpose(1, 2)
    elif case == "window":
        kw["window"] = 0
    with pytest.raises((ValueError, TypeError)):
        check_attention_inputs(q, k, k, **kw)


def test_cuda_wrappers_refuse_cpu_tensors():
    q, kk, v = _t(*_randn(2, (1, 64, 2, 32), (1, 64, 1, 32), (1, 64, 1, 32)))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, kk, v)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(q[:, 0], kk, v, torch.zeros(64, dtype=torch.int32),
                              torch.zeros((), dtype=torch.int32))


def test_other_devices_are_refused():
    q = torch.zeros(1, 64, 2, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.flash_attention(q, q, q)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_library_name_tracks_sources():
    a = _build._lib_path("flash_attention")
    b = _build._lib_path("decode_attention")
    assert a.parent == _build.BUILD_DIR and a.suffix == ".so" and a != b
    with pytest.raises(KeyError):
        _build.build("no_such_kernel")


# ---------------------------------------- split-KV decode: the algorithm ----
def _split_decode_model(q, kc, vc, pos, npos, window, splits, tile=64):
    """The decode kernel's arithmetic in torch: per split, an online
    softmax over its tiles with the -1e30 sentinel; then the combine with
    weights exp(m_s - max m)."""
    b, h, d = q.shape
    c, kh = kc.shape[1], kc.shape[2]
    g = h // kh
    tiles = -(-c // tile)
    per = -(-tiles // splits)
    qg = q.reshape(b, kh, g, d).double()
    ms, ls, accs = [], [], []
    for s in range(splits):
        m = torch.full((b, kh, g), R.NEG_INF, dtype=torch.float64)
        l = torch.zeros(b, kh, g, dtype=torch.float64)
        acc = torch.zeros(b, kh, g, d, dtype=torch.float64)
        for t in range(s * per, min(tiles, (s + 1) * per)):
            sl = slice(t * tile, min(c, (t + 1) * tile))
            kt, vt, kp = kc[:, sl].double(), vc[:, sl].double(), pos[sl]
            sc = torch.einsum("bkgd,btkd->bkgt", qg, kt) / d ** 0.5
            ok = (kp >= 0) & (kp <= npos)
            if window is not None:
                ok &= kp > npos - window
            sc = torch.where(ok, sc, torch.tensor(R.NEG_INF, dtype=torch.float64))
            if sc.shape[-1] < tile:      # the ragged tile's padding slots are masked too
                pad = torch.full((*sc.shape[:-1], tile - sc.shape[-1]), R.NEG_INF,
                                 dtype=torch.float64)
                sc = torch.cat([sc, pad], -1)
                vt = torch.cat([vt, torch.zeros(b, tile - vt.shape[1], kh, d,
                                                dtype=torch.float64)], 1)
            m_new = torch.maximum(m, sc.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bkgt,btkd->bkgd", p, vt)
            m = m_new
        ms.append(m), ls.append(l), accs.append(acc)
    m_all = torch.stack(ms)
    w = torch.exp(m_all - m_all.amax(0))
    lsum = (w * torch.stack(ls)).sum(0)
    out = (w[..., None] * torch.stack(accs)).sum(0) / lsum.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, d).float()


@pytest.mark.parametrize("c,fill,window,splits", [
    (256, 16, None, 4),     # splits 2-4 hold only empty slots: weight 0
    (256, 100, 48, 3),      # window: the first split's slots are all outside it
    (100, 100, None, 2),    # ragged last tile
    (1024, 1024, None, 8),  # qwen3-4b's shape at batch 4 on 132 SMs
])
def test_split_decode_arithmetic_matches_plain(c, fill, window, splits):
    q, kc, vc, pos, npos = _t(*_decode_inputs(2, 8, 2, 32, c, fill))
    want = R.decode_attention_ref(q, kc, vc, pos, npos, window)
    got = _split_decode_model(q, kc, vc, pos, npos, window, splits)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


def test_split_decode_arithmetic_wraparound():
    q, kc, vc, pos, npos = _t(*_wrapped_inputs())
    want = R.decode_attention_ref(q, kc, vc, pos, npos, 64)
    for splits in (1, 2):
        got = _split_decode_model(q, kc, vc, pos, npos, 64, splits, tile=32)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


@pytest.mark.parametrize("b,kh,c,sms", [(4, 8, 1024, 132), (1, 1, 64, 132), (2, 2, 100, 132),
                                        (64, 8, 1024, 132), (1, 1, 4096, 132), (2, 4, 448, 16)])
def test_num_splits_cover_every_tile(b, kh, c, sms):
    tiles = -(-c // 64)
    s = num_splits(b, kh, c, sms)
    per = -(-tiles // s)
    assert 1 <= s <= tiles and (s - 1) * per < tiles <= s * per
    if (b, kh, c) == (4, 8, 1024):
        assert s == 8                  # 256 blocks for 132 SMs
