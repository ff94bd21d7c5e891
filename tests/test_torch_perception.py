"""The perception slice of the port (``repro_torch.perception``) against the
JAX reference (``repro.perception``) on the CPU, on the same inputs.

Scenes are NumPy draws, so the port's must equal the reference's bit for
bit.  Detector weights come from the reference's own ``init`` (threefry,
key 7: the pipelines' default) and are carried across by
``params_from_numpy`` (HWIO → OIHW convs).  Bounds: host NumPy copies
exactly; the device stages at f32 reduction-order differences —
``preprocess_device`` 1e-6, backbone features 1e-5, boxes 1e-4 px (a few
f32 ulps at 320 px), objectness scores 1e-6, the lane map 3.3e-6, the lane
fits to their systems' condition number; counts, indices and keep masks
exactly (ties broken lower index first, as ``lax.top_k`` does).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.perception import data as rdata, detector as rdet, lane as rlane  # noqa: E402
from repro.perception import pipelines as rpipe  # noqa: E402
from repro_torch.perception import data as tdata, detector as tdet, lane as tlane  # noqa: E402
from repro_torch.perception import pipelines as tpipe  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SCENARIOS = ("city", "residential", "road")
BOX = dict(atol=1e-4, rtol=0)
PROB = dict(atol=1e-6, rtol=0)
# the lane map is sigmoid(14 (max - avg - 0.33)): slope up to 3.5 on a
# pooled mean whose f32 sums the two sides order differently (up to 16 ulps
# of 1.0 between them)
LANE_PROB = dict(atol=3.5 * 2.0**-20, rtol=0)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jitted(fn, *args):
    """The reference's device functions run jitted, as its pipelines run
    them (XLA fuses and orders the reductions differently from eager)."""
    return [np.asarray(x) for x in jax.tree.leaves(jax.jit(fn)(*args))]


@pytest.fixture(scope="module")
def ref_params():
    """Reference weights per pipeline, as its factories draw them (key 7)."""
    key = jax.random.PRNGKey(7)
    one = np_tree(rdet.OneStageDetector().init(key))
    lane = np_tree(rlane.LaneDetector().init(key))
    return {"one_stage": one, "early_exit": one,
            "two_stage": np_tree(rdet.TwoStageDetector().init(key)),
            "lane": lane, "lane_static": lane}


def scene_image(scenario="city", index=1, rain=0.0, seed=4):
    return rdata.generate_scene(rdata.SceneConfig(scenario, rain, seed), index).image


def standardized(scenario="city", index=1, rain=0.0, scale=1.0, pad=True):
    return rpipe.preprocess(scene_image(scenario, index, rain), scale, pad)


# ------------------------------------------------------------------ data --

@pytest.mark.parametrize("rain", [0.0, 4.0, 50.0])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_generate_scene_is_bit_for_bit(scenario, rain):
    for seed, index in ((0, 0), (3, 1), (4, 7)):
        want = rdata.generate_scene(rdata.SceneConfig(scenario, rain, seed), index)
        got = tdata.generate_scene(tdata.SceneConfig(scenario, rain, seed), index)
        for field in ("image", "boxes", "lane_pixels"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field
        assert (got.scenario, got.rain) == (want.scenario, want.rain)


# ------------------------------------------------------------ preprocess --

@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("scale", [1.0, 0.75, 0.5, 0.6])
def test_preprocess_host_and_device(scale, pad):
    raw = scene_image("city", 2, rain=50.0)
    want = rpipe.preprocess(raw, scale, pad)
    assert np.array_equal(tpipe.preprocess(raw, scale, pad), want)
    dev_want = np.asarray(rpipe.preprocess_device(jnp.asarray(raw), scale, pad))
    dev_got = tpipe.preprocess_device(torch.from_numpy(raw), scale, pad).numpy()
    assert dev_got.shape == dev_want.shape == want.shape
    np.testing.assert_allclose(dev_got, dev_want, atol=1e-6, rtol=1e-6)


def test_preprocess_device_std_is_population_std():
    """``correction=1`` (torch's default) would scale every pixel by
    sqrt((n - 1) / n), off by ~2e-6 of the value: more than the bound."""
    raw = scene_image("road", 3)
    img = torch.flip(torch.from_numpy(raw), dims=(-1,))
    sample_std = ((img - img.mean()) / (img.std() + 1e-6)).numpy()
    want = np.asarray(rpipe.preprocess_device(jnp.asarray(raw)))
    np.testing.assert_allclose(tpipe.preprocess_device(torch.from_numpy(raw)).numpy(), want,
                               atol=1e-6, rtol=1e-6)
    assert np.abs(sample_std - want).max() > 1e-6


# -------------------------------------------------------------- backbone --

@pytest.mark.parametrize("shape", [(96, 320), (87, 251), (48, 160), (9, 17)])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_backbone_apply_matches(ref_params, depth, shape):
    """"SAME" at stride 2 pads 0 before and 1 after an even dimension and 1
    on both sides of an odd one; ``padding=1`` would shift every window."""
    rng = np.random.default_rng(depth)
    x = rng.standard_normal((2, *shape, 3)).astype(np.float32)
    p = ref_params["one_stage"]["backbone"]
    want, = jitted(lambda v: rdet.backbone_apply(p, v, depth=depth), jnp.asarray(x))
    got = tdet.backbone_apply(tdet.params_from_numpy(p, "cpu"), torch.from_numpy(x), depth)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_params_from_numpy_transposes_convs_only(ref_params):
    p = ref_params["two_stage"]
    got = tdet.params_from_numpy(p, "cpu")
    w = p["backbone"]["conv2"]
    assert got["backbone"]["conv2"].shape == (w.shape[3], w.shape[2], 3, 3)
    assert np.array_equal(got["backbone"]["conv2"].numpy(), w.transpose(3, 2, 0, 1))
    for head in ("rpn", "refine"):
        assert np.array_equal(got[head].numpy(), p[head])


def test_port_init_draws_the_reference_distributions():
    """Drawn in the reference's HWIO layout (fan-in 3·3·Cin), then bridged;
    one generator gives every detector the same backbone."""
    gen = torch.Generator().manual_seed(7)
    one = tdet.OneStageDetector().init(gen, "cpu")
    two = tdet.TwoStageDetector().init(gen, "cpu")
    for name in ("conv1", "conv2", "conv3"):
        assert torch.equal(one["backbone"][name], two["backbone"][name])
    w = torch.cat([one["backbone"][n].reshape(-1) for n in ("conv2", "conv3")])
    assert abs(w.std().item() - 1.4 / np.sqrt(9 * 16)) < 0.01


# ------------------------------------------------------------------- NMS --

def _tie_case(name):
    rng = np.random.default_rng(11)
    n = 40
    yx = rng.uniform(0, 80, (n, 2)).astype(np.float32)
    hw = rng.uniform(6, 30, (n, 2)).astype(np.float32)
    boxes = np.concatenate([yx, yx + hw], 1)
    if name == "three_levels":
        scores = rng.choice(np.float32([0.2, 0.5, 0.9]), n)
    elif name == "all_equal":
        scores = np.full(n, 0.7, np.float32)
    elif name == "saturated":       # the sigmoid saturates to exactly 1.0
        scores = np.asarray(jax.nn.sigmoid(jnp.asarray(rng.uniform(0, 30, n).astype(np.float32))))
    else:                           # fewer candidates than k
        scores = rng.choice(np.float32([0.3, 0.6]), 20)
        boxes = boxes[:20]
    return boxes, scores.astype(np.float32)


@pytest.mark.parametrize("case", ["three_levels", "all_equal", "saturated", "short"])
def test_static_nms_ties_break_as_lax_top_k(case):
    boxes, scores = _tie_case(case)
    assert len(np.unique(scores)) < len(scores)
    want = [np.asarray(x) for x in rdet.static_nms(jnp.asarray(boxes), jnp.asarray(scores), 32)]
    got = [x.numpy() for x in tdet.static_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 32)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
    assert np.array_equal(got[3], want[3])           # indices
    assert np.array_equal(got[2], want[2])           # keep
    assert np.array_equal(got[1], want[1])           # scores
    assert np.array_equal(got[0], want[0])           # boxes (a gather)


def test_dynamic_nms_is_the_reference():
    boxes, scores = _tie_case("three_levels")
    scores = scores + np.random.default_rng(2).uniform(0, 1e-3, len(scores)).astype(np.float32)
    assert np.array_equal(tdet.dynamic_nms(boxes, scores), rdet.dynamic_nms(boxes, scores))


# ------------------------------------------------------------- detectors --

@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("cell", [8, 16, 32])
def test_one_stage_infer_matches(ref_params, cell, depth):
    p = ref_params["one_stage"]
    rdt = rdet.OneStageDetector(cell=cell, depth=depth)
    tdt = tdet.OneStageDetector(cell=cell, depth=depth)
    tp = tdet.params_from_numpy(p, "cpu")
    for scenario, index in (("city", 1), ("road", 2)):
        img = standardized(scenario, index)
        tb, ts, tk = jitted(lambda v: rdt.infer(p, v), jnp.asarray(img))
        gb, gs, gk = (x.numpy() for x in tdt.infer(tp, torch.from_numpy(img)))
        assert gb.shape == tb.shape == (min(32, (96 // cell) * (320 // cell)), 4)
        np.testing.assert_allclose(gs, ts, **PROB)
        np.testing.assert_allclose(gb, tb, **BOX)
        assert np.array_equal(gk, tk)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_two_stage_device_and_host_match(ref_params, scenario):
    p = ref_params["two_stage"]
    rdt, tdt = rdet.TwoStageDetector(), tdet.TwoStageDetector()
    tp = tdet.params_from_numpy(p, "cpu")
    ref_out, port_out = [], []
    for index in (1, 2, 3):
        img = standardized(scenario, index)
        rf, ro = jitted(lambda v: rdt.infer_device(p, v), jnp.asarray(img))
        tf, to = (x.numpy() for x in tdt.infer_device(tp, torch.from_numpy(img)))
        np.testing.assert_allclose(tf, rf, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(to, ro, **PROB)
        rb, rn = rdt.post_host(p, rf, ro)
        tb, tn = tdt.post_host(tp, tf, to)
        assert tn == rn and tb.shape == rb.shape
        np.testing.assert_allclose(tb, rb, **BOX)
        ref_out.append((rf, ro))
        port_out.append((tf, to))
    active = np.array([True, False, True])
    want = rdt.post_host_batch(p, *(np.stack(x) for x in zip(*ref_out)), active=active)
    got = tdt.post_host_batch(tp, *(np.stack(x) for x in zip(*port_out)), active=active)
    assert got[1] is None and want[1] is None
    for (gb, gn), (wb, wn) in ((got[0], want[0]), (got[2], want[2])):
        assert gn == wn and gb.shape == wb.shape
        np.testing.assert_allclose(gb, wb, **BOX)


def test_two_stage_reads_the_refinement_head_back_once(ref_params):
    tp = tdet.params_from_numpy(ref_params["two_stage"], "cpu")
    det = tdet.TwoStageDetector()
    first = det._refine(tp)
    assert det._refine(tp) is first
    assert np.array_equal(first, ref_params["two_stage"]["refine"])


@pytest.mark.parametrize("rain", [0.0, 50.0])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_lane_device_and_host_match(ref_params, scenario, rain):
    p = ref_params["lane"]
    rdt, tdt = rlane.LaneDetector(), tlane.LaneDetector()
    tp = tdet.params_from_numpy(p, "cpu")
    for index in (1, 2):
        img = standardized(scenario, index, rain)
        rprob, = jitted(lambda v: rdt.infer_device(p, v), jnp.asarray(img))
        tprob = tdt.infer_device(tp, torch.from_numpy(img))
        np.testing.assert_allclose(tprob.numpy(), rprob, **LANE_PROB)
        rfits, rn = rdt.cluster_host(rprob)
        tfits, tn = tdt.cluster_host(tprob.numpy())
        assert tn == rn and len(tfits) == len(rfits)
        for a, b in zip(tfits, rfits):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        rfit, rpix = jitted(rdt.static_fit_device, jnp.asarray(rprob))
        tfit, tpix = tdt.static_fit_device(torch.from_numpy(rprob.copy()))
        assert int(tpix) == int(rpix)
        assert_fits_close(tfit.numpy(), rfit, rprob)


def test_static_fit_ties_take_the_first_anchor():
    """x = 12 lies halfway between the anchors 8 and 16 of a 40-wide map:
    both libraries take the first minimum; and equal probabilities are
    ranked lower index first."""
    prob = np.full((12, 40), 0.1, np.float32)
    prob[:, 12] = 0.9          # one column, every value tied
    prob[3:9, 20] = 0.9        # halfway between 16 and 24
    det_r, det_t = rlane.LaneDetector(), tlane.LaneDetector()
    want = jitted(lambda v: det_r.static_fit_device(v, k=24), jnp.asarray(prob))
    got = [x.numpy() for x in det_t.static_fit_device(torch.from_numpy(prob), k=24)]
    assert int(got[1]) == int(want[1]) == 18
    assert_fits_close(got[0], want[0], prob, k=24)


def lane_systems(prob, k=256, n_lanes=4):
    """The normal equations ``static_fit_device`` solves, rebuilt in
    float64 (their sums are of small integers, exact in f32 as well)."""
    h, w = prob.shape
    idx = np.argsort(-prob.reshape(-1), kind="stable")[:k]
    ys, xs = (idx // w).astype(np.float64), (idx % w).astype(np.float64)
    valid = prob.reshape(-1)[idx] > tlane.LaneDetector().pixel_thr
    anchors = (np.arange(n_lanes) + 1.0) * (w / (n_lanes + 1.0))
    assign = np.argmin(np.abs(xs[:, None] - anchors[None]), 1)
    a = np.stack([ys**2, ys, np.ones_like(ys)], 1)
    return [(a * ((assign == lane) & valid)[:, None]).T @ a + 1e-3 * np.eye(3)
            for lane in range(n_lanes)]


def assert_fits_close(got, want, prob, k=256):
    """Two float32 LU solves of one system differ by up to its condition
    number times the unit roundoff (relative, first order): the lane
    systems reach κ ≈ 1e8, so no fixed rtol holds for them all."""
    for lane, ata in enumerate(lane_systems(prob, k, got.shape[0])):
        bound = np.linalg.cond(ata) * 2.0**-24 * np.linalg.norm(want[lane])
        assert np.linalg.norm(got[lane] - want[lane]) <= bound, (lane, got[lane], want[lane])


# ------------------------------------------------------------- pipelines --

def _frames_agree(got, want):
    assert len(got) == len(want)
    for (gs, go), (ws, wo) in zip(got, want):
        assert np.array_equal(gs.image, ws.image)
        assert go.num_proposals == wo.num_proposals
        assert go.num_objects == wo.num_objects
        assert go.boxes.shape == wo.boxes.shape
        np.testing.assert_allclose(go.boxes, wo.boxes, **BOX)


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("name", ["one_stage", "early_exit", "two_stage", "lane", "lane_static"])
def test_run_pipeline_matches_per_frame(ref_params, name, scenario):
    cfg = rdata.SceneConfig(scenario, seed=5)
    rrec, want = rpipe.run_pipeline(name, cfg, n=8, collect=True)
    trec, got = tpipe.run_pipeline(name, tdata.SceneConfig(scenario, seed=5), n=8, collect=True,
                                   device="cpu", params=ref_params[name])
    _frames_agree(got, want)
    assert set(trec.stages()) == set(rrec.stages()) == {
        "read", "pre_processing", "inference", "post_processing"}
    assert np.array_equal(trec.meta_series("num_proposals"), rrec.meta_series("num_proposals"))


def test_pipeline_registry_matches():
    assert set(tpipe.PIPELINES) == set(rpipe.PIPELINES)
    with pytest.raises(KeyError, match="unknown pipeline"):
        tpipe.build_pipeline("nope", device="cpu")


@pytest.mark.parametrize("name,scale", [("one_stage", 0.9), ("early_exit", 0.7),
                                        ("two_stage", 0.9), ("one_stage", 0.5)])
def test_unpadded_scales_match(ref_params, name, scale):
    """λ off the 8-px grid rounds to a valid shape, and the detections come
    back in the original frame as the reference's do."""
    cfg = rdata.SceneConfig("city", seed=4)
    want = rpipe.run_pipeline(name, cfg, n=3, scale=scale, pad=False, collect=True)[1]
    got = tpipe.run_pipeline(name, tdata.SceneConfig("city", seed=4), n=3, scale=scale,
                             pad=False, collect=True, device="cpu", params=ref_params[name])[1]
    _frames_agree(got, want)


def test_caller_images_of_odd_shape(ref_params):
    """Caller-supplied images: all recorded, none eaten by the warm-up,
    which is a zero frame of their shape."""
    imgs = [scene_image("city", i)[:87, :251].copy() for i in (1, 2, 3)]
    cfg = rdata.SceneConfig("city", seed=4)
    rrec, want = rpipe.run_pipeline("one_stage", cfg, images=imgs, collect=True)
    trec, got = tpipe.run_pipeline("one_stage", tdata.SceneConfig("city", seed=4), images=imgs,
                                   collect=True, device="cpu", params=ref_params["one_stage"])
    assert len(trec.records) == len(rrec.records) == 3
    _frames_agree(got, want)


def test_legacy_wrappers_match_runner_contract():
    rec = tpipe.run_lane_static(tdata.SceneConfig("city", seed=4), n=2, device="cpu")
    assert len(rec.records) == 2
    assert rec.meta_series("num_objects").shape == (2,)


def test_run_frame_reads_back_once(ref_params, monkeypatch):
    """Post receives NumPy leaves from one ``to_host`` call per frame."""
    calls = []
    real = tpipe.to_host

    def counting(tree):
        calls.append(tree)
        return real(tree)

    monkeypatch.setattr(tpipe, "to_host", counting)
    built = tpipe.build_pipeline("two_stage", device="cpu", params=ref_params["two_stage"])
    tpipe.run_frame(built, tdata.generate_scene(tdata.SceneConfig("city"), 1))
    assert len(calls) == 1 and isinstance(calls[0], tuple) and len(calls[0]) == 2


@pytest.mark.parametrize("name", ["one_stage", "two_stage"])
def test_post_batch_matches_post_per_slot(ref_params, name):
    """The vectorized post stage over a stacked batch gives each active
    slot what the serial post gives its frame (the two-stage refinement as
    N-row products rounds apart from the per-proposal loop, as in the
    reference: boxes to 1e-4 px)."""
    from repro_torch.core.timing import to_host

    built = tpipe.build_pipeline(name, scale=0.75, pad=False, device="cpu",
                                 params=ref_params[name])
    hosts = [to_host(built.infer(torch.from_numpy(standardized("city", i, 0.0, 0.75, False))))
             for i in (1, 2, 3)]
    batch = tuple(np.stack(leaves) for leaves in zip(*hosts))
    active = np.array([True, False, True])
    got = built.post_batch(batch, active)
    assert got[1] is None
    for slot in (0, 2):
        want = built.post(hosts[slot])
        assert (got[slot].num_objects, got[slot].num_proposals) == \
            (want.num_objects, want.num_proposals)
        assert got[slot].boxes.shape == want.boxes.shape
        np.testing.assert_allclose(got[slot].boxes, want.boxes, **BOX)


def test_fusion_synchronizer_is_the_reference():
    from repro.perception import fusion as rfusion
    from repro_torch.perception import fusion as tfusion

    rng = np.random.default_rng(6)
    topics = ["cam", "lidar", "radar"]
    syncs = [m.ApproxTimeSynchronizer(topics, queue_size=5, slop=0.02) for m in (rfusion, tfusion)]
    for step in range(300):
        topic = topics[rng.integers(3)]
        stamp = step * 0.01 + rng.normal(0, 0.01)
        evs = [s.add(topic, stamp, None, now=step * 0.01 + 0.003) for s in syncs]
        assert (evs[0] is None) == (evs[1] is None)
        if evs[0] is not None:
            assert (evs[1].stamp, evs[1].emitted_at, evs[1].stamps) == \
                (evs[0].stamp, evs[0].emitted_at, evs[0].stamps)
    want, got = syncs
    assert len(got.events) == len(want.events) > 20
    assert (got.dropped_overflow, got.dropped_sweep) == (want.dropped_overflow, want.dropped_sweep)
    assert got.delays() == want.delays()
    with pytest.raises(KeyError, match="unknown topic"):
        got.add("sonar", 0.0, None, now=0.0)


# ---------------------------------------------------------------- device --

def test_importing_perception_creates_no_cuda_context():
    code = (
        "import torch, repro_torch.perception as p, repro_torch.anytime as a\n"
        "import repro_torch.perception.pipelines as pp\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert 'KEY' not in vars(pp)\n"
        "import sys\n"
        "for name, mod in list(sys.modules.items()):\n"
        "    if name.startswith(('repro_torch.perception', 'repro_torch.anytime')):\n"
        "        for v in vars(mod).values():\n"
        "            assert not isinstance(v, (torch.Tensor, torch.Generator)), name\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("name", ["one_stage", "early_exit", "two_stage", "lane", "lane_static"])
def test_cuda_without_a_card_raises(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.build_pipeline(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.run_pipeline(name, tdata.SceneConfig("city"), n=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdet.params_from_numpy({"head": np.zeros((16, 4), np.float32)}, "cuda")
