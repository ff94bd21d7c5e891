"""The scans' gradients in the port against the JAX reference, on the CPU.

The reference has no Pallas backward for either scan: ``jax.value_and_grad``
differentiates its jnp chunked forms, ``_wkv_chunked``
(``repro/models/rwkv6.py``) and ``_ssd_chunked`` (``repro/models/mamba2.py``).
The port ports them (``repro_torch.kernels.ref.rwkv6_wkv_chunked`` and
``mamba2_ssd_chunked``), and its autograd Functions ``RWKV6WKV`` and
``Mamba2SSD`` recompute them in the backward; on the CPU the Functions'
forwards are the step recurrences, so these tests run the backward that the
card runs.  Inputs come from numpy seeds and go through both packages.

Tolerances, each with its reason:
- the chunked forms' y and final state: 1e-5 of the largest element (f32,
  the same formulas summed in different orders);
- their vector-Jacobian products and the Functions' gradients: the
  ``GRAD_RTOL`` of ``tests/test_torch_train.py``, 1e-4 relative and 1e-4 of
  the leaf's largest magnitude;
- where the reference's gradient overflows (0·inf in the masked upper
  triangle), the port's, taken in float64, against autograd through the
  step recurrence in float64: 1e-9 of the largest element, and 1e-9
  absolute for a leaf whose gradient is all below 1 (dlogw at logw = -25
  is of order exp(-25); the chunked form's f64 rounding is 1e-15).

The backward kernels' formulas (``ref.rwkv6_wkv_bwd_ref``,
``ref.mamba2_ssd_bwd_ref``: the recurrence run forwards for the states and
backwards for their gradients, dlogw and dl as reverse sums), in float64:
against the reference's VJP at ``GRAD_RTOL``, against the plain version the
CPU runs (``wkv_chunked_grads`` / ``ssd_chunked_grads``, in float64) at
1e-9 of the leaf's largest element (both exact but for f64 rounding), and
against autograd through the f64 step recurrence at 1e-9 as above, at a
ragged length and where the reference overflows.  Their segment form
(``ref.rwkv6_wkv_bwd_segments`` / ``mamba2_ssd_bwd_segments``: the backward
kernels' segments, summaries, carry and offsets, with the segment length
as an argument), in float64, against the f64 recurrence at 1e-9 and the
reference's VJP at ``GRAD_RTOL``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models.mamba2 import _ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro.models.rwkv6 import _wkv_chunked as jax_wkv_chunked  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels.mamba2_ssd import BWD_SEGMENT, Mamba2SSD, mamba2_ssd_bwd_cuda, \
    ssd_chunked_grads  # noqa: E402
from repro_torch.kernels.rwkv6_scan import RWKV6WKV, rwkv6_wkv_bwd_cuda, \
    wkv_chunked_grads  # noqa: E402
from repro_torch.kernels.rwkv6_scan import BWD_SEGMENT as WKV_BWD_SEGMENT  # noqa: E402
from repro_torch.models import mamba2 as tmamba2  # noqa: E402
from repro_torch.models import rwkv6 as trwkv6  # noqa: E402

GRAD_RTOL = 1e-4
CHUNKS = [16, 32, 64]


def _softplus(x):
    return np.logaddexp(x, 0.0).astype(np.float32)


def _rwkv_inputs(seed, decay, b=2, s=128, h=3, dk=16):
    """r, k, v, logw, u and a nonzero s0; ``decay`` is "model" (-softplus
    of a normal, as the model's _decay) or a constant logw (-25)."""
    rng = np.random.default_rng(seed)
    r, k, v, w = (rng.standard_normal((b, s, h, dk)).astype(np.float32) for _ in range(4))
    logw = -_softplus(w) if decay == "model" else np.full_like(w, decay)
    u = rng.standard_normal((h, dk)).astype(np.float32)
    s0 = rng.standard_normal((b, h, dk, dk)).astype(np.float32)
    return [r, k, v, logw, u], s0


def _ssd_inputs(seed, b=2, s=128, h=4, p=8, n=6, dt_scale=1.0):
    """x, dt (softplus'd), a (negative), B, C and a nonzero h0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (_softplus(rng.standard_normal((b, s, h))) * dt_scale).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return [x, dt, a, bm, cm], h0


def _close(got, want, rel, what="", floor=1e-30):
    """Within ``rel`` of the largest |want| (or of ``floor``, if larger)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), floor), err_msg=what)


def _grad_close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def _jit_vjp(fn, args, ct):
    """The reference's VJP of ``fn`` at ``args`` and cotangent ``ct``, jitted
    whole (one compilation instead of one per op)."""
    return jax.jit(lambda a, c: jax.vjp(fn, *a)[1](c))(args, ct)


def _t(xs, grad=False, dtype=torch.float32):
    return [torch.tensor(x, dtype=dtype, requires_grad=grad) for x in xs]


# ---------------------------------------------------------- chunked forms ----
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("decay", ["model", -25.0])
def test_wkv_chunked_matches_reference(chunk, decay):
    """y and the final state from a nonzero s0; logw = -25 included (where
    both chunked forms drift from the recurrence alike)."""
    ins, s0 = _rwkv_inputs(1, decay)
    yj, sj = jax.jit(jax_wkv_chunked, static_argnums=5)(*map(jnp.asarray, ins), chunk,
                                                        jnp.asarray(s0))
    yt, st = trwkv6._wkv_chunked(*_t(ins), chunk, torch.from_numpy(s0))
    assert yt.shape == yj.shape and st.shape == sj.shape
    _close(yt, yj, 1e-5, "y")
    _close(st, sj, 1e-5, "s_final")


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(chunk, with_h0):
    ins, h0 = _ssd_inputs(2)
    yj, hj = jax.jit(jax_ssd_chunked, static_argnums=5)(*map(jnp.asarray, ins), chunk,
                                                        jnp.asarray(h0) if with_h0 else None)
    yt, ht = tmamba2._ssd_chunked(*_t(ins), chunk, torch.from_numpy(h0) if with_h0 else None)
    assert yt.shape == yj.shape and ht.shape == hj.shape
    _close(yt, yj, 1e-5, "y")
    _close(ht, hj, 1e-5, "h_final")


# ------------------------------------------------------------------ VJPs ----
def _vjp_pair(jax_fn, torch_fn, ins, state, seed):
    """The reference's and the port's VJPs of (y, final state) at the same
    cotangents, with respect to every input and the initial state."""
    rng = np.random.default_rng(seed)
    args = [*map(jnp.asarray, ins), jnp.asarray(state)]
    dy, ds = (rng.standard_normal(t.shape).astype(np.float32)
              for t in jax.eval_shape(jax_fn, *args))
    want = _jit_vjp(jax_fn, args, (jnp.asarray(dy), jnp.asarray(ds)))
    leaves = _t(ins + [state], grad=True)
    yt, st = torch_fn(*leaves)
    got = torch.autograd.grad((yt, st), leaves, (torch.from_numpy(dy), torch.from_numpy(ds)))
    return got, want


@pytest.mark.parametrize("chunk", CHUNKS)
def test_wkv_chunked_vjp_matches_reference(chunk):
    ins, s0 = _rwkv_inputs(3, "model")
    got, want = _vjp_pair(lambda *a: jax_wkv_chunked(*a[:5], chunk, a[5]),
                          lambda *a: R.rwkv6_wkv_chunked(*a[:5], chunk, a[5]), ins, s0, 4)
    for name, g, w in zip(("r", "k", "v", "logw", "u", "s0"), got, want):
        _grad_close(g, w, name)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_ssd_chunked_vjp_matches_reference(chunk):
    ins, h0 = _ssd_inputs(5)
    got, want = _vjp_pair(lambda *a: jax_ssd_chunked(*a[:5], chunk, a[5]),
                          lambda *a: R.mamba2_ssd_chunked(*a[:5], chunk, a[5]), ins, h0, 6)
    for name, g, w in zip(("x", "dt", "a", "B", "C", "h0"), got, want):
        _grad_close(g, w, name)


# -------------------------------------------------- the autograd Functions ----
@pytest.mark.parametrize("chunk,grad_chunk", [(16, 16), (32, 64), (32, 32)])
def test_rwkv6_function_gradients_match_reference(chunk, grad_chunk):
    """ops.rwkv6_wkv under grad applies RWKV6WKV (the step recurrence
    forward on the CPU); its gradients are the reference's VJP of
    _wkv_chunked from a zero state at ``grad_chunk`` (the model's: 64 at
    rwkv6-3b, where the kernel's chunk is 32), and every input gets one."""
    ins, _ = _rwkv_inputs(7, "model")
    b, _, h, dk = ins[0].shape
    rng = np.random.default_rng(8)
    zero = jnp.zeros((b, h, dk, dk), jnp.float32)
    fn = jax.jit(lambda *a: jax_wkv_chunked(*a, grad_chunk, zero)[0])
    yj = fn(*map(jnp.asarray, ins))
    dy = rng.standard_normal(yj.shape).astype(np.float32)
    want = _jit_vjp(fn, list(map(jnp.asarray, ins)), jnp.asarray(dy))
    leaves = _t(ins, grad=True)
    y = K.rwkv6_wkv(*leaves, chunk, grad_chunk=grad_chunk)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "RWKV6WKVBackward"
    _close(y.detach(), yj, 1e-5, "y")
    y.backward(torch.from_numpy(dy))
    for name, leaf, w in zip(("r", "k", "v", "logw", "u"), leaves, want):
        assert leaf.grad is not None and leaf.grad.abs().max() > 0, name
        _grad_close(leaf.grad, w, name)


@pytest.mark.parametrize("chunk", [16, 32])
def test_mamba2_function_gradients_match_reference(chunk):
    """ops.mamba2_ssd under grad applies Mamba2SSD; its gradients are the
    reference's VJP of _ssd_chunked from a zero state at the same chunk,
    and every input gets one."""
    ins, _ = _ssd_inputs(9)
    rng = np.random.default_rng(10)
    fn = jax.jit(lambda *a: jax_ssd_chunked(*a, chunk)[0])
    yj = fn(*map(jnp.asarray, ins))
    dy = rng.standard_normal(yj.shape).astype(np.float32)
    want = _jit_vjp(fn, list(map(jnp.asarray, ins)), jnp.asarray(dy))
    leaves = _t(ins, grad=True)
    y = K.mamba2_ssd(*leaves, chunk=chunk, head_block=2)
    assert type(y.grad_fn).__name__ == "Mamba2SSDBackward"
    _close(y.detach(), yj, 1e-5, "y")
    y.backward(torch.from_numpy(dy))
    for name, leaf, w in zip(("x", "dt", "a", "B", "C"), leaves, want):
        assert leaf.grad is not None and leaf.grad.abs().max() > 0, name
        _grad_close(leaf.grad, w, name)


def test_functions_take_only_the_gradients_asked_for():
    """Inputs that do not require grad get none; without grad the ops make
    their plain call and record no graph."""
    ins, _ = _rwkv_inputs(11, "model", b=1, s=32, h=2)
    r, k, v, logw, u = _t(ins)
    r.requires_grad_()
    y = K.rwkv6_wkv(r, k, v, logw, u, 16)
    gr = torch.autograd.grad(y.sum(), r)[0]
    assert gr.shape == r.shape and k.grad is None
    with torch.no_grad():
        assert K.rwkv6_wkv(r, k, v, logw, u, 16).grad_fn is None
    xs, _ = _ssd_inputs(12, b=1, s=32)
    x, dt, a, bm, cm = _t(xs)
    dt.requires_grad_()
    ys = K.mamba2_ssd(x, dt, a, bm, cm, chunk=16, head_block=1)
    assert torch.autograd.grad(ys.sum(), dt)[0].shape == dt.shape and x.grad is None


def test_rwkv6_grad_chunk_must_divide_s():
    ins, _ = _rwkv_inputs(13, "model", b=1, s=48, h=1)
    leaves = _t(ins, grad=True)
    with pytest.raises(ValueError, match="grad_chunk"):
        K.rwkv6_wkv(*leaves, 16, grad_chunk=32)


def test_functions_apply_directly():
    """The Functions as the ops apply them: outputs equal the plain forward
    (the step recurrences), bit for bit on the CPU."""
    ins, _ = _rwkv_inputs(14, "model", b=1, s=32, h=2)
    leaves = _t(ins, grad=True)
    assert torch.equal(RWKV6WKV.apply(*leaves, 16, 32).detach(), R.rwkv6_wkv_ref(*_t(ins)))
    xs, _ = _ssd_inputs(15, b=1, s=32)
    leaves = _t(xs, grad=True)
    assert torch.equal(Mamba2SSD.apply(*leaves, 16, 1).detach(), R.mamba2_ssd_ref(*_t(xs)))


# --------------------------------------- where the reference's gradient is NaN ----
def test_wkv_gradient_is_finite_where_the_reference_overflows():
    """At logw = -25 the reference's dlogw is NaN: above the diagonal of a
    64-row chunk exp(cum[t-1] - cum[u]) overflows to inf, and jnp.where's
    masked gradient times it is 0·inf.  The port's value is the same (the
    masked entries are zeroed before the exp too); its gradient is finite
    and, in float64, that of the step recurrence."""
    ins, s0 = _rwkv_inputs(16, -25.0, b=1, s=128, h=2)
    zero = jnp.zeros_like(jnp.asarray(s0))
    want = jax.jit(jax.grad(lambda *a: jax_wkv_chunked(*a, 64, zero)[0].sum(),
                            argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, ins))
    assert not np.isfinite(np.asarray(want[3])).all()
    leaves = _t(ins, grad=True, dtype=torch.float64)
    y, _ = R.rwkv6_wkv_chunked(*leaves, 64, torch.zeros(s0.shape, dtype=torch.float64))
    got = torch.autograd.grad(y.sum(), leaves)
    rec = _t(ins, grad=True, dtype=torch.float64)
    y_rec, _ = R.rwkv6_recurrent(*rec, torch.zeros(s0.shape, dtype=torch.float64))
    oracle = torch.autograd.grad(y_rec.sum(), rec)
    for name, g, w, j in zip(("r", "k", "v", "logw", "u"), got, oracle, want):
        assert torch.isfinite(g).all(), name
        _close(g, w, 1e-9, name, floor=1.0)
        if name != "logw":
            _grad_close(g, j, name)


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """zamba2-2.7b's 256-row chunk at its initial dt·A (softplus(0)·-1 ≈
    -0.69 a step): above the diagonal exp(cum[t] - cum[u]) reaches exp(176)
    = inf, and the reference's ddt and da are NaN.  The port's gradient is
    finite and, in float64, that of the step recurrence."""
    ins, _ = _ssd_inputs(17, b=1, s=256, h=2, p=4, n=4)
    ins[1] = np.full_like(ins[1], np.log(2.0))
    ins[2] = -np.ones_like(ins[2])
    want = jax.jit(jax.grad(lambda *a: jax_ssd_chunked(*a, 256)[0].sum(),
                            argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, ins))
    assert not np.isfinite(np.asarray(want[1])).all()
    leaves = _t(ins, grad=True, dtype=torch.float64)
    got = torch.autograd.grad(R.mamba2_ssd_chunked(*leaves, 256)[0].sum(), leaves)
    rec = _t(ins, grad=True, dtype=torch.float64)
    oracle = torch.autograd.grad(_ssd_recurrent64(*rec).sum(), rec)
    for name, g, w in zip(("x", "dt", "a", "B", "C"), got, oracle):
        assert torch.isfinite(g).all(), name
        _close(g, w, 1e-9, name, floor=1.0)


def _ssd_recurrent64(x, dt, a, bm, cm):
    """``ref.mamba2_ssd_ref``'s recurrence without its cast to float32."""
    b, s, h, p = x.shape
    hst = torch.zeros((b, h, p, bm.shape[-1]), dtype=x.dtype)
    ys = []
    for t in range(s):
        hst = hst * torch.exp(dt[:, t] * a)[..., None, None] \
            + torch.einsum("bh,bn,bhp->bhpn", dt[:, t], bm[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", cm[:, t], hst))
    return torch.stack(ys, dim=1)


# ------------------------------------------ the backward kernels' formulas ----
F64 = torch.float64
WKV_LEAVES = ("r", "k", "v", "logw", "u")
SSD_LEAVES = ("x", "dt", "a", "B", "C")


def _cotangent(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("chunk", [16, 64])
def test_wkv_bwd_formulas_match_reference_vjp(chunk):
    """rwkv6_wkv_bwd_ref in float64 against the reference's VJP of
    _wkv_chunked from a zero state (f32) at GRAD_RTOL, and against
    wkv_chunked_grads (the CPU's backward) in float64 at 1e-9."""
    ins, s0 = _rwkv_inputs(20, "model", s=64)
    zero = jnp.zeros(s0.shape, jnp.float32)
    dy = _cotangent(21, ins[0].shape)
    want = _jit_vjp(lambda *a: jax_wkv_chunked(*a, chunk, zero)[0],
                    list(map(jnp.asarray, ins)), jnp.asarray(dy))
    got = R.rwkv6_wkv_bwd_ref(*_t(ins, dtype=F64), torch.tensor(dy, dtype=F64))
    plain = wkv_chunked_grads(_t(ins, dtype=F64), chunk, torch.tensor(dy, dtype=F64))
    for name, g, w, p in zip(WKV_LEAVES, got, want, plain):
        assert g.shape == p.shape and g.dtype == F64, name
        _grad_close(g, w, name)
        _close(g, p, 1e-9, name)


@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_bwd_formulas_match_reference_vjp(chunk):
    """mamba2_ssd_bwd_ref in float64 against the reference's VJP of
    _ssd_chunked from a zero state (f32) at GRAD_RTOL, and against
    ssd_chunked_grads (the CPU's backward) in float64 at 1e-9."""
    ins, _ = _ssd_inputs(22, s=64)
    dy = _cotangent(23, ins[0].shape)
    want = _jit_vjp(lambda *a: jax_ssd_chunked(*a, chunk)[0], list(map(jnp.asarray, ins)),
                    jnp.asarray(dy))
    got = R.mamba2_ssd_bwd_ref(*_t(ins, dtype=F64), torch.tensor(dy, dtype=F64))
    plain = ssd_chunked_grads(_t(ins, dtype=F64), chunk, torch.tensor(dy, dtype=F64))
    for name, g, w, p in zip(SSD_LEAVES, got, want, plain):
        assert g.shape == p.shape and g.dtype == F64, name
        _grad_close(g, w, name)
        _close(g, p, 1e-9, name)


@pytest.mark.parametrize("decay,s", [("model", 37), (-25.0, 64)])
def test_wkv_bwd_formulas_match_the_f64_recurrence(decay, s):
    """At a ragged length (no chunk but 1 and 37 divides 37) and at
    logw = -25, where the reference's dlogw is NaN: the formulas against
    autograd through the f64 step recurrence, 1e-9 (absolute below 1:
    dlogw at logw = -25 is of order exp(-25), while the reverse sum's terms
    are of order 1)."""
    ins, s0 = _rwkv_inputs(24, decay, b=1, s=s, h=2)
    dy = torch.tensor(_cotangent(25, ins[0].shape), dtype=F64)
    got = R.rwkv6_wkv_bwd_ref(*_t(ins, dtype=F64), dy)
    rec = _t(ins, grad=True, dtype=F64)
    y, _ = R.rwkv6_recurrent(*rec, torch.zeros(s0.shape, dtype=F64))
    for name, g, w in zip(WKV_LEAVES, got, torch.autograd.grad(y, rec, dy)):
        assert torch.isfinite(g).all(), name
        _close(g, w, 1e-9, name, floor=1.0)


@pytest.mark.parametrize("case", ["ragged", "zamba2_init", "large_dt"])
def test_ssd_bwd_formulas_match_the_f64_recurrence(case):
    """At a ragged length (S = 37), at zamba2-2.7b's initial dt·A ≈ -0.69 a
    step over 256 rows and at dt scaled by 40, where the reference's ddt
    and da are NaN at a chunk of the whole sequence: the formulas against
    autograd through the f64 step recurrence, 1e-9 (absolute below 1)."""
    if case == "ragged":
        ins, _ = _ssd_inputs(26, b=1, s=37, h=2, p=4, n=4)
    elif case == "zamba2_init":
        ins, _ = _ssd_inputs(27, b=1, s=256, h=2, p=4, n=4)
        ins[1] = np.full_like(ins[1], np.log(2.0))
        ins[2] = -np.ones_like(ins[2])
    else:
        ins, _ = _ssd_inputs(28, b=1, s=64, h=2, p=4, n=4, dt_scale=40.0)
    dy = torch.tensor(_cotangent(29, ins[0].shape), dtype=F64)
    got = R.mamba2_ssd_bwd_ref(*_t(ins, dtype=F64), dy)
    rec = _t(ins, grad=True, dtype=F64)
    oracle = torch.autograd.grad(_ssd_recurrent64(*rec), rec, dy)
    for name, g, w in zip(SSD_LEAVES, got, oracle):
        assert torch.isfinite(g).all(), name
        _close(g, w, 1e-9, name, floor=1.0)


# -------------------------------- the backward kernels' segment form ----
# (case, S, segment length L, chunk of the reference's VJP or None where
# its gradient is NaN): L dividing S, L not dividing S, S below L, the
# kernels' own L with S one row past a multiple of it, and logw = -25 /
# zamba2-2.7b's initial decay over 256 rows
WKV_SEG_CASES = [("divides", 64, 16, 16), ("ragged", 37, 16, 37), ("short", 10, 16, 10),
                 ("kernel_seg", 129, WKV_BWD_SEGMENT, 43), ("logw25", 64, 16, None)]
SSD_SEG_CASES = [("divides", 64, 16, 16), ("ragged", 37, 16, 37), ("short", 10, 16, 10),
                 ("kernel_seg", 129, BWD_SEGMENT, 43), ("zamba2_init", 256, BWD_SEGMENT, 64)]


@pytest.mark.parametrize("case,s,seg,chunk", WKV_SEG_CASES)
def test_wkv_bwd_segments_match_the_recurrence(case, s, seg, chunk):
    """ref.rwkv6_wkv_bwd_segments (the backward kernel's segments,
    summaries, carry and dlogw offsets) in float64 against autograd through
    the f64 step recurrence at 1e-9 (absolute below 1), and where the
    reference's gradient is finite against its VJP of _wkv_chunked at
    GRAD_RTOL."""
    ins, s0 = _rwkv_inputs(32, -25.0 if case == "logw25" else "model", b=1, s=s, h=2, dk=8)
    dy = _cotangent(33, ins[0].shape)
    got = R.rwkv6_wkv_bwd_segments(*_t(ins, dtype=F64), torch.tensor(dy, dtype=F64), seg)
    rec = _t(ins, grad=True, dtype=F64)
    y, _ = R.rwkv6_recurrent(*rec, torch.zeros(s0.shape, dtype=F64))
    for name, g, w in zip(WKV_LEAVES, got, torch.autograd.grad(y, rec, torch.tensor(dy, dtype=F64))):
        assert torch.isfinite(g).all(), name
        _close(g, w, 1e-9, name, floor=1.0)
    if chunk is not None:
        zero = jnp.zeros(s0.shape, jnp.float32)
        want = _jit_vjp(lambda *a: jax_wkv_chunked(*a, chunk, zero)[0],
                        list(map(jnp.asarray, ins)), jnp.asarray(dy))
        for name, g, w in zip(WKV_LEAVES, got, want):
            _grad_close(g, w, name)


@pytest.mark.parametrize("case,s,seg,chunk", SSD_SEG_CASES)
def test_ssd_bwd_segments_match_the_recurrence(case, s, seg, chunk):
    """ref.mamba2_ssd_bwd_segments in float64 against autograd through the
    f64 step recurrence at 1e-9 (absolute below 1), and against the
    reference's VJP of _ssd_chunked at GRAD_RTOL (at zamba2-2.7b's initial
    decay over 256 rows, at a chunk of 64, where it is finite)."""
    ins, _ = _ssd_inputs(34, b=1, s=s, h=3, p=4, n=4)
    if case == "zamba2_init":
        ins[1] = np.full_like(ins[1], np.log(2.0))
        ins[2] = -np.ones_like(ins[2])
    dy = _cotangent(35, ins[0].shape)
    got = R.mamba2_ssd_bwd_segments(*_t(ins, dtype=F64), torch.tensor(dy, dtype=F64), seg)
    rec = _t(ins, grad=True, dtype=F64)
    oracle = torch.autograd.grad(_ssd_recurrent64(*rec), rec, torch.tensor(dy, dtype=F64))
    for name, g, w in zip(SSD_LEAVES, got, oracle):
        assert torch.isfinite(g).all(), name
        _close(g, w, 1e-9, name, floor=1.0)
    want = _jit_vjp(lambda *a: jax_ssd_chunked(*a, chunk)[0], list(map(jnp.asarray, ins)),
                    jnp.asarray(dy))
    for name, g, w in zip(SSD_LEAVES, got, want):
        _grad_close(g, w, name)


def test_backward_kernels_refuse_cpu_tensors():
    """The backward kernels' wrappers take CUDA tensors only: on the CPU
    the Functions run the plain versions, and a wrapper given CPU tensors
    raises rather than stand in for a launch."""
    ins, _ = _rwkv_inputs(30, "model", b=1, s=32, h=2)
    r = _t(ins)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rwkv6_wkv_bwd_cuda(*r, torch.zeros_like(r[0]), 32)
    xs, _ = _ssd_inputs(31, b=1, s=32)
    x = _t(xs)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mamba2_ssd_bwd_cuda(*x, torch.zeros_like(x[0]), 32, 2)
    assert rwkv6_wkv_bwd_cuda.launches == 0 and mamba2_ssd_bwd_cuda.launches == 0
