"""The port's attention kernels against the reference's Pallas kernels.

CPU arms: the port's plain versions (``repro_torch.kernels.ref``, which the
wrappers use for CPU tensors) against the JAX Pallas kernels run as
``tests/test_kernels.py`` runs them (``interpret=True``), over that file's
flash and decode sweeps plus head_dim 80 (zamba2's shared block) and the
ring-buffer wraparound, on the same inputs made with numpy.  Tolerance: f32 2e-5 absolute and relative, the reference
sweep's own (``test_kernels.py:23``); both sides accumulate in f32 in a
different order.

The hand-written kernels themselves are held against the plain versions
on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``; their
arithmetic is written out here in torch (the bf16 flash kernel's tiles,
exp2 softmax, P split into bf16 hi and lo, and the log-sum-exp it writes;
the bf16 backward kernels' tile walks, P rebuilt from that log-sum-exp and
P and dS split into hi and lo for dV, dK and dQ, with a test for each
split showing that one rounding misses the band; the decode kernel's
warps, splits and merges) and held against the plain versions on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.decode_attention import decode_attention_fwd  # noqa: E402
from repro.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro.kernels.ref import flash_attention_ref as jax_flash_attention_ref  # noqa: E402
from repro.models.attention import dense_attention  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels.decode_attention import MAX_SPLITS, decode_attention_cuda, \
    num_splits  # noqa: E402
from repro_torch.kernels.flash_attention import FlashAttention, check_attention_inputs, \
    flash_attention_bwd_cuda, flash_attention_cuda  # noqa: E402

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
    assert K.launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 0,
                                 "decode_attention": 0, "rwkv6_wkv": 0, "rwkv6_wkv_bwd": 0,
                                 "mamba2_ssd": 0, "mamba2_ssd_bwd": 0}


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


def test_backward_wrapper_refuses_cpu_tensors():
    q, kk, v = _t(*_randn(2, (1, 64, 2, 32), (1, 64, 1, 32), (1, 64, 1, 32)))
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q, kk, v, q, q, lse)


def test_backward_wrapper_needs_the_forward_lse():
    """No hidden recompute: without the forward's log-sum-exp the backward
    raises before anything else."""
    q, kk, v = _t(*_randn(2, (1, 64, 2, 32), (1, 64, 1, 32), (1, 64, 1, 32)))
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_cuda(q, kk, v, q, q, None)


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


# ------------------------------------------- attention's gradient (CPU) ----
# The plain backward (the backward kernel's plain version) in formulas,
# against autograd of the plain forward and against jax.vjp of the
# reference's attention, at f32: G = H/K of 1, 4 and 7, head_dims 64, 80
# and 128, causal, windowed (also without causality) and neither.
# Tolerance 2e-5 absolute and relative, the forward sweep's: the two sides
# sum the same products in different orders in f32.
BWD_SHAPES = [(1, 96, 4, 4, 64), (2, 80, 8, 2, 80), (1, 64, 7, 1, 128), (1, 100, 14, 2, 64)]
BWD_MASKS = [(True, None), (True, 24), (False, None), (False, 24)]


def _bwd_inputs(b, s, h, k, d, seed=11):
    return _randn(seed, (b, s, h, d), (b, s, k, d), (b, s, k, d), (b, s, h, d))


@pytest.mark.parametrize("b,s,h,k,d", BWD_SHAPES)
@pytest.mark.parametrize("causal,window", BWD_MASKS)
def test_flash_bwd_ref_matches_autograd(b, s, h, k, d, causal, window):
    q, kk, v, do = _t(*_bwd_inputs(b, s, h, k, d))
    q, kk, v = (x.requires_grad_() for x in (q, kk, v))
    out = R.flash_attention_ref(q, kk, v, causal, window)
    want = torch.autograd.grad(out, (q, kk, v), do)
    got = R.flash_attention_bwd_ref(q.detach(), kk.detach(), v.detach(), out.detach(), do,
                                    causal, window)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F32)


@pytest.mark.parametrize("b,s,h,k,d", BWD_SHAPES)
@pytest.mark.parametrize("causal,window", BWD_MASKS)
@pytest.mark.parametrize("oracle", ["kernels.ref", "dense_attention"])
def test_flash_bwd_ref_matches_jax_vjp(b, s, h, k, d, causal, window, oracle):
    import jax

    q, kk, v, do = _bwd_inputs(b, s, h, k, d)
    pos = jnp.arange(s, dtype=jnp.int32)
    fn = {"kernels.ref": lambda q, k, v: jax_flash_attention_ref(q, k, v, causal, window),
          "dense_attention": lambda q, k, v: dense_attention(q, k, v, pos, pos, causal,
                                                             window)}[oracle]
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(kk), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = _t(q, kk, v, do)
    got = R.flash_attention_bwd_ref(tq, tk, tv, torch.from_numpy(np.array(out)), tdo,
                                    causal, window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


@pytest.mark.parametrize("b,s,h,k,d", BWD_SHAPES[:2])
@pytest.mark.parametrize("causal,window", BWD_MASKS)
def test_flash_function_on_cpu_gives_autograd_gradients(b, s, h, k, d, causal, window):
    """FlashAttention's wiring without a card: on CPU tensors its forward
    and backward are the plain versions, and its gradients are autograd's
    of the plain forward, through a loss downstream of the output (whose
    gradient, w, is standard normal as dO is in the tests above).  No
    kernel launches."""
    q, kk, v, w = _t(*_bwd_inputs(b, s, h, k, d, seed=12))
    leaves = [x.clone().requires_grad_() for x in (q, kk, v)]
    K.reset_launch_counts()
    got = torch.autograd.grad((FlashAttention.apply(*leaves, causal, window) * w).sum(), leaves)
    plain = [x.clone().requires_grad_() for x in (q, kk, v)]
    want = torch.autograd.grad((R.flash_attention_ref(*plain, causal, window) * w).sum(), plain)
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wt.numpy(), **F32)
    assert not any(K.launch_counts().values())


def test_ops_take_the_plain_differentiable_versions_on_cpu():
    """On CPU tensors under grad the ops are the plain versions, which
    autograd differentiates; none raises or launches."""
    q, kk, v = (x.requires_grad_() for x in _t(*_randn(3, (1, 64, 2, 32), (1, 64, 1, 32),
                                                      (1, 64, 1, 32))))
    K.reset_launch_counts()
    out = K.flash_attention(q, kk, v)
    assert out.grad_fn is not None and "FlashAttention" not in type(out.grad_fn).__name__
    r, k2, v2, w = (x.requires_grad_() for x in _t(*_randn(4, *[(1, 16, 2, 8)] * 4)))
    y = K.rwkv6_wkv(r, k2, v2, -torch.nn.functional.softplus(w), torch.zeros(2, 8), chunk=16)
    assert y.requires_grad
    assert not any(K.launch_counts().values())


# ---------------------------------------- split-KV decode: the algorithm ----
def _online(m, l, acc, sc, vt):
    """One online-softmax update with scores sc (..., t) over values vt."""
    m_new = torch.maximum(m, sc.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(sc - m_new[..., None])
    return m_new, l * corr + p.sum(-1), acc * corr[..., None] + torch.einsum(
        "bkgt,btkd->bkgd", p, vt)


def _merge(ms, ls, accs):
    """Merge partial softmax states with weights exp(m_s - max m)."""
    m_all = torch.stack(ms)
    w = torch.exp(m_all - m_all.amax(0))
    return m_all.amax(0), (w * torch.stack(ls)).sum(0), (w[..., None] * torch.stack(accs)).sum(0)


def _split_decode_model(q, kc, vc, pos, npos, window, splits, tile=64, warps=8):
    """The decode kernel's arithmetic in torch: in each split (one block of
    the cluster) each warp owns ``tile / warps`` slots of every tile and
    runs its own online softmax over them with the -1e30 sentinel (the
    ragged last tile's padding slots masked too); the block merges its
    warps, then the cluster merges the splits, each with weights
    exp(m - max m)."""
    b, h, d = q.shape
    c, kh = kc.shape[1], kc.shape[2]
    g = h // kh
    tiles = -(-c // tile)
    per = -(-tiles // splits)
    rows = tile // warps
    qg = q.reshape(b, kh, g, d).double()
    kp_all = torch.cat([pos, torch.full((tiles * tile - c,), -1, dtype=pos.dtype)])
    pad = torch.zeros(b, tiles * tile - c, kh, d, dtype=torch.float64)
    k_all, v_all = torch.cat([kc.double(), pad], 1), torch.cat([vc.double(), pad], 1)
    neg = torch.tensor(R.NEG_INF, dtype=torch.float64)
    blocks = []
    for s in range(splits):
        states = []
        for w in range(warps):
            m = torch.full((b, kh, g), R.NEG_INF, dtype=torch.float64)
            l = torch.zeros(b, kh, g, dtype=torch.float64)
            acc = torch.zeros(b, kh, g, d, dtype=torch.float64)
            for t in range(s * per, min(tiles, (s + 1) * per)):
                sl = slice(t * tile + w * rows, t * tile + (w + 1) * rows)
                kp, vt = kp_all[sl], v_all[:, sl]
                sc = torch.einsum("bkgd,btkd->bkgt", qg, k_all[:, sl]) / d ** 0.5
                ok = (kp >= 0) & (kp <= npos)
                if window is not None:
                    ok &= kp > npos - window
                m, l, acc = _online(m, l, acc, torch.where(ok, sc, neg), vt)
            states.append((m, l, acc))
        blocks.append(_merge(*zip(*states)))
    _, lsum, out = _merge(*zip(*blocks))
    return (out / lsum.clamp_min(1e-30)[..., None]).reshape(b, h, d).float()


@pytest.mark.parametrize("c,fill,window,splits", [
    (256, 16, None, 4),     # splits 2-4 hold only empty slots: weight 0
    (256, 100, 48, 3),      # window: the first split's slots are all outside it
    (100, 100, None, 2),    # ragged last tile
    (1024, 1024, None, 8),  # qwen3-4b's shape at batch 4: the wrapper's bound on 132 SMs
    (1024, 1024, None, 4),  # what the launch runs there: 4 splits' clusters fit at once
    (4096, 1000, 256, MAX_SPLITS),   # the cluster cap: 8 tiles per split
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
                                        (64, 8, 1024, 132), (1, 1, 4096, 132), (2, 4, 448, 16),
                                        (1, 8, 1024, 132)])
def test_num_splits_cover_every_tile(b, kh, c, sms):
    tiles = -(-c // 64)
    s = num_splits(b, kh, c, sms)
    per = -(-tiles // s)
    assert 1 <= s <= min(tiles, MAX_SPLITS) and (s - 1) * per < tiles <= s * per
    if (b, kh, c) == (4, 8, 1024):
        assert s == 8                  # 256 blocks for 132 SMs
    if (b, kh, c) == (1, 8, 1024):
        assert s == MAX_SPLITS         # batch 1: the cluster cap leaves 64 blocks


@pytest.mark.parametrize("most,want", [(8, 8), (7, 4), (4, 4), (3, 2), (1, 1), (0, 1)])
def test_num_splits_halve_until_clusters_fit(most, want):
    """qwen3-4b at batch 4 (16 tiles, bound 8): when clusters of more than
    ``most`` blocks do not all fit at once, the splits halve to the first
    count that does (8 -> 4 -> 2 -> 1), each split still owning a tile."""
    asked = []

    def fit(splits):
        asked.append(splits)
        return splits <= most

    assert num_splits(4, 8, 1024, 132, fit) == want
    assert asked == [s for s in (8, 4, 2) if s >= want]


# ------------------------------------ bf16 flash (wgmma): the algorithm ----
LOG2E = 1.4426950408889634
TOL_BF16 = dict(atol=2e-5, rtol=4e-3)   # chip_smoke.py's TOL[bfloat16]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _flash_wgmma_model(q, k, v, causal, window, bq=128, bk=64, split_p=True):
    """The bf16 flash kernel's arithmetic in torch: per 64-row warpgroup of
    a 128-row q tile, the block's 64-key tiles (tiles outside the band
    skipped), scores of bf16 q and k summed in f32 and scaled into the
    log2 domain, masks with the -1e30 sentinel, an exp2 online softmax, and
    P split into bf16 hi and lo, each times bf16 v, summed in f32; the
    output rounded to bf16 once.  ``split_p=False`` keeps only hi.  Returns
    the output and the rows' log-sum-exp as the kernel writes it, m +
    log2(l) (f32 (B,H,S), the log2 domain)."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    kx, vx = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    scale = LOG2E / d ** 0.5
    out = torch.zeros(b, s, h, d)
    lse = torch.zeros(b, h, s)
    for q0 in range(0, s, bq):
        q_last = min(q0 + bq - 1, s - 1)
        hi = q_last // bk + 1 if causal else -(-s // bk)
        lo = min(max(0, q0 - window + 1) // bk if window else 0, max(hi - 1, 0))
        for first in (q0, q0 + 64):
            if first >= s:
                continue
            last = first + 63
            rows = torch.arange(first, min(last + 1, s))
            qt = q[:, rows]                                   # (b, r, h, d)
            m = torch.full((b, len(rows), h), R.NEG_INF)
            l = torch.zeros(b, len(rows), h)
            o = torch.zeros(b, len(rows), h, d)
            for j in range(lo, hi):
                k0 = j * bk
                if (causal and k0 > last) or (window and k0 + bk - 1 <= first - window):
                    continue
                cols = torch.arange(k0, min(k0 + bk, s))
                sc = torch.einsum("brhd,bchd->brhc", qt, kx[:, cols]) * scale
                ok = torch.ones(len(rows), len(cols), dtype=torch.bool)
                if causal:
                    ok &= cols[None] <= rows[:, None]
                if window:
                    ok &= cols[None] > rows[:, None] - window
                sc = torch.where(ok[None, :, None], sc, torch.tensor(R.NEG_INF))
                m_new = torch.maximum(m, sc.amax(-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(sc - m_new[..., None])
                p_hi = _bf16(p)
                p_lo = _bf16(p - p_hi) if split_p else torch.zeros_like(p)
                l = l * corr + p.sum(-1)
                o = o * corr[..., None] + torch.einsum("brhc,bchd->brhd", p_hi, vx[:, cols]) \
                    + torch.einsum("brhc,bchd->brhd", p_lo, vx[:, cols])
                m = m_new
            out[:, rows] = o / l.clamp_min(1e-30)[..., None]
            lse[:, :, rows] = (m + torch.log2(l.clamp_min(1e-30))).transpose(1, 2)
    return _bf16(out), lse


@pytest.mark.parametrize("b,s,h,k,d", [(1, 128, 4, 4, 32), (2, 256, 4, 2, 32), (1, 128, 8, 1, 64),
                                       (1, 200, 4, 2, 128), (1, 128, 4, 4, 80), (1, 100, 2, 1, 16)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 96])
def test_flash_wgmma_arithmetic_matches_plain(b, s, h, k, d, causal, window):
    """The output at the bf16 band, and the rows' log-sum-exp that the
    kernel writes for the backward (m + log2 l of its online softmax) at
    the f32 band of the plain logsumexp."""
    q, kk, v = (_bf16(x) for x in _t(*_randn(4, (b, s, h, d), (b, s, k, d), (b, s, k, d))))
    want = R.flash_attention_ref(q, kk, v, causal, window)
    got, lse = _flash_wgmma_model(q, kk, v, causal, window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL_BF16)
    np.testing.assert_allclose(lse.numpy(), R.flash_attention_lse_ref(q, kk, causal, window),
                               **F32)


@pytest.mark.parametrize("b,s,h,k,d", [(2, 256, 4, 2, 32), (1, 200, 4, 2, 128)])
def test_flash_single_rounding_of_p_breaks_tolerance(b, s, h, k, d):
    """Why the kernel multiplies P's lo part too: with P rounded to bf16
    once, outputs near zero miss TOL_BF16 (an error of up to 2**-8 of
    sum p|v| / l against an atol of 2e-5)."""
    q, kk, v = (_bf16(x) for x in _t(*_randn(4, (b, s, h, d), (b, s, k, d), (b, s, k, d))))
    want = R.flash_attention_ref(q, kk, v, True, None)
    got, _ = _flash_wgmma_model(q, kk, v, True, None, split_p=False)
    assert ((got - want).abs() > TOL_BF16["atol"] + TOL_BF16["rtol"] * want.abs()).any()


# ------------------------------- bf16 flash backward (wgmma): the algorithm ----
def _allowed(rows, cols, s, causal, window):
    ok = (rows[:, None] < s) & (cols[None] < s)
    if causal:
        ok &= cols[None] <= rows[:, None]
    if window:
        ok &= cols[None] > rows[:, None] - window
    return ok


def _parts(x, split):
    hi = _bf16(x)
    return (hi, _bf16(x - hi)) if split else (hi,)


def _flash_bwd_wgmma_model(q, k, v, o, do, lse, causal, window, split=("dv", "dk", "dq"),
                           bt=64, bq=128):
    """The bf16 backward kernels' arithmetic in torch, from bf16 inputs and
    the forward's log2-domain lse: delta = rowsum(dO o O) in f32; the dK/dV
    kernel's walk (a block per 64-key tile, the q tiles of its band) and
    the dQ kernel's (a 64-row warpgroup of a 128-row q tile, its KV tiles);
    per tile, products of bf16 values summed in f32, P = exp2(S log2(e)/√D
    - lse) with P = 0 where masked, dS = P o (dP - delta), and P (for dV)
    and dS (for dK, dQ) fed to the next product as bf16 hi and lo, or hi
    alone where ``split`` leaves the product out; the group's sum, the
    scale and one bf16 rounding at the end."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    kx, vx = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    scale2 = LOG2E / d ** 0.5
    delta = (do * o).sum(-1)                     # (b, s, h)
    lse_t = lse.transpose(1, 2)                  # (b, s, h)
    nt = -(-s // bt)

    def tile(rows, cols):
        sc = torch.einsum("brhd,bchd->brhc", q[:, rows], kx[:, cols]) * scale2
        ok = _allowed(rows, cols, s, causal, window)[None, :, None]
        p = torch.where(ok, torch.exp2(sc - lse_t[:, rows, :, None]), torch.zeros(()))
        dp = torch.einsum("brhd,bchd->brhc", do[:, rows], vx[:, cols])
        return p, p * (dp - delta[:, rows, :, None])

    dq = torch.zeros(b, s, h, d)
    dkh, dvh = torch.zeros(b, s, h, d), torch.zeros(b, s, h, d)
    for kt in range(nt):                         # dK/dV: one block per key tile
        cols = torch.arange(kt * bt, min(kt * bt + bt, s))
        qlo = kt if causal else 0
        qhi = min(nt, (int(cols[-1]) + window - 1) // bt + 1) if window else nt
        for qt in reversed(range(qlo, qhi)):     # the farthest q tile first
            rows = torch.arange(qt * bt, min(qt * bt + bt, s))
            p, ds = tile(rows, cols)
            for x in _parts(p, "dv" in split):
                dvh[:, cols] += torch.einsum("brhc,brhd->bchd", x, do[:, rows])
            for x in _parts(ds, "dk" in split):
                dkh[:, cols] += torch.einsum("brhc,brhd->bchd", x, q[:, rows])
    for first in range(0, s, bt):                # dQ: a warpgroup's 64 rows
        q0 = first - first % bq
        rows = torch.arange(first, min(first + bt, s))
        hi = min(int(rows[-1]) // bt + 1, (min(q0 + bq, s) - 1) // bt + 1) if causal else nt
        lo = max(0, first - window + 1) // bt if window else 0
        for kt in range(lo, hi):
            cols = torch.arange(kt * bt, min(kt * bt + bt, s))
            _, ds = tile(rows, cols)
            for x in _parts(ds, "dq" in split):
                dq[:, rows] += torch.einsum("brhc,bchd->brhd", x, kx[:, cols])
    sc = 1 / d ** 0.5
    dk = dkh.reshape(b, s, kh, g, d).sum(3) * sc
    dv = dvh.reshape(b, s, kh, g, d).sum(3)
    return _bf16(dq * sc), _bf16(dk), _bf16(dv)


def _bwd_case(b, s, h, k, d, causal, window, seed=5):
    q, kk, v, do = (_bf16(x) for x in _t(*_randn(seed, (b, s, h, d), (b, s, k, d), (b, s, k, d),
                                                 (b, s, h, d))))
    o, lse = _flash_wgmma_model(q, kk, v, causal, window)
    return q, kk, v, o, do, lse


# head_dim 16, 32, 64, 80 and 128 (every swizzle), G = H/K of 1, 2, 4 and 7,
# ragged S (100, 200)
BWD_WGMMA_SHAPES = [(1, 100, 2, 1, 16), (2, 256, 4, 2, 32), (1, 128, 7, 1, 64),
                    (1, 100, 4, 4, 80), (1, 200, 4, 1, 128)]


@pytest.mark.parametrize("b,s,h,k,d", BWD_WGMMA_SHAPES)
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None)])
def test_flash_bwd_wgmma_arithmetic_matches_plain(b, s, h, k, d, causal, window):
    """The backward kernels' arithmetic, from the forward kernel's output
    and lse, against the f32 formulas at the bf16 band (chip_smoke.py's
    TOL[bfloat16], which the card holds the kernels to)."""
    q, kk, v, o, do, lse = _bwd_case(b, s, h, k, d, causal, window)
    want = R.flash_attention_bwd_ref(q, kk, v, o, do, causal, window)
    got = _flash_bwd_wgmma_model(q, kk, v, o, do, lse, causal, window)
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), w.numpy(), **TOL_BF16)


@pytest.mark.parametrize("product", ["dv", "dk", "dq"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_single_rounding_breaks_tolerance(product, causal):
    """Why each of the three products that take P or dS multiplies the lo
    part too: with P (for dV) or dS (for dK, dQ) rounded to bf16 once, that
    gradient misses TOL_BF16 where it is near zero (an error up to 2**-9 of
    sum |x y| against an atol of 2e-5), while the other two, still split,
    hold it."""
    q, kk, v, o, do, lse = _bwd_case(1, 200, 4, 2, 128, causal, None)
    want = R.flash_attention_bwd_ref(q, kk, v, o, do, causal, None)
    kept = tuple(x for x in ("dv", "dk", "dq") if x != product)
    got = dict(zip(("dq", "dk", "dv"),
                   _flash_bwd_wgmma_model(q, kk, v, o, do, lse, causal, None, split=kept)))
    for name, w in zip(("dq", "dk", "dv"), want):
        out = (got[name] - w).abs() > TOL_BF16["atol"] + TOL_BF16["rtol"] * w.abs()
        assert out.any() == (name == product), name
