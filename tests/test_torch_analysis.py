"""The port's timing-hazard analysis (``repro_torch.analysis``: tvlint and
the TraceSentinel) against the reference's ``repro.analysis``, on the CPU.

Every case of the reference's ``tests/test_analysis.py`` and its two
sentinel tests in ``tests/test_obs.py`` has a counterpart here:

* TV003, TV007 and TV008 keep the reference's patterns, so the *same*
  snippet goes through both linters and the findings must be equal: rule,
  axis, line, col, scope, message and key (the same ``_fingerprint``).
* TV001, TV002, TV004, TV005 and TV006 are re-derived for torch, so each
  reference snippet is paired with its torch translation, kept line for
  line; both linters must give the same list of (rule, scope, line) and
  the same ``via <helper>`` notes, silences included.
* The sentinel counts program builds (CUDA graph captures on the card,
  each shard's step build on the CPU); on the CPU it arms no sync guard
  (there is no device), so the guard's own cases run on the card in
  ``tests/test_torch_cuda.py``.

In one process the file takes about 15 s, most of it two golden replays
through one shared scheduler.  The chaos CLI's sentinel is checked where
that CLI already runs, in ``tests/test_torch_chaos.py``.
"""
import json
import re
import shutil
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.analysis as ref_analysis  # noqa: E402
from repro.analysis import lint_source as ref_lint_source  # noqa: E402

import repro_torch.analysis as port_analysis  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    AXES,
    RULES,
    SentinelReport,
    TimingHazardError,
    TraceSentinel,
    diff_baseline,
    lint_source,
    load_baseline,
    report_dict,
    write_baseline,
)
from repro_torch.analysis.__main__ import main as tvlint_main  # noqa: E402
from repro_torch.analysis.lint import lint_paths  # noqa: E402
from repro_torch.analysis.sentinel import SYNC_DEBUG_MODES  # noqa: E402
from repro_torch.batched import PipelinedExecutor  # noqa: E402
from repro_torch.core import monitoring  # noqa: E402

REPO = Path(__file__).parent.parent
TORCH_BASELINE = REPO / "analysis" / "torch_baseline.json"


def _lint(src: str):
    return lint_source(textwrap.dedent(src), "pkg/mod.py")


def _ref_lint(src: str):
    return ref_lint_source(textwrap.dedent(src), "pkg/mod.py")


def _triples(findings):
    return [(f.rule, f.scope, f.line) for f in findings if not f.suppressed]


def _vias(findings):
    return sorted(v for f in findings for v in re.findall(r"via (\w+)\(", f.message))


def _same_fields(findings):
    return [(f.rule, f.axis, f.line, f.col, f.scope, f.message, f.key, f.suppressed)
            for f in findings]


# ------------------------------------------- rules kept unchanged ------
# TV003, TV007, TV008, finding metadata and suppressions: one snippet,
# both linters, equal findings.

SAME = {
    # test_tv003_flags_global_and_unseeded_rng
    "tv003_global_and_unseeded_rng": ("""
        import random
        import numpy as np

        def make_noise(n):
            a = np.random.normal(size=n)
            rng = np.random.default_rng()
            b = random.random()
            return a, rng, b
    """, "TV003", 3),
    # test_tv003_flags_wall_clock_seed (both snippets)
    "tv003_wall_clock_key": ("""
        import time
        import jax

        def fresh_key():
            return jax.random.PRNGKey(int(time.time()))
    """, "TV003", 1),
    "tv003_wall_clock_rng": ("""
        import time
        import numpy as np

        def fresh_rng():
            return np.random.default_rng(time.time_ns())
    """, "TV003", 1),
    # test_tv003_silent_on_seeded_rng
    "tv003_silent_on_seeded_rng": ("""
        import numpy as np
        import jax

        def make(seed):
            rng = np.random.default_rng(seed)
            key = jax.random.PRNGKey(42)
            return rng, key
    """, "TV003", 0),
    # test_tv008_flags_bare_except_pass_in_hot_function
    "tv008_bare_except_pass": ("""
        def tick(engine, frames):
            try:
                engine.step(frames)
            except:
                pass
    """, "TV008", 1),
    # test_tv008_flags_broad_except_continue_in_loop
    "tv008_broad_except_continue": ("""
        def drain(queue):
            for item in queue:
                try:
                    item.process()
                except Exception:
                    continue
    """, "TV008", 1),
    # test_tv008_flags_unbounded_while_true_retry
    "tv008_unbounded_retry": ("""
        def submit(req, backend):
            while True:
                try:
                    backend.send(req)
                    break
                except IOError:
                    continue
    """, "TV008", 1),
    # test_tv008_silent_outside_hot_context
    "tv008_silent_outside_hot": ("""
        def load_config(path):
            try:
                return open(path).read()
            except Exception:
                pass
    """, "TV008", 0),
    # test_tv008_silent_on_bounded_retry_and_surfacing_handlers
    "tv008_silent_bounded_retry": ("""
        def step(engine, frames, log):
            # bounded retry: the for loop caps attempts
            for attempt in range(3):
                try:
                    return engine.run(frames)
                except IOError:
                    log.warn("retry %d", attempt)
            # specific exception with a fallback that surfaces the fault
            try:
                return engine.run(frames)
            except IOError as e:
                log.error(e)
                raise

        def drain(queue):
            # while True bounded by a re-raising handler
            while True:
                try:
                    return queue.pop()
                except IndexError:
                    raise RuntimeError("drained empty queue")
    """, "TV008", 0),
    # test_findings_carry_location_axis_and_hint
    "metadata": ("""
        import numpy as np

        def tick(n):
            return np.random.normal(size=n)
    """, "TV003", 1),
    # test_inline_suppression_marks_finding_suppressed
    "suppress_inline": ("""
        import numpy as np

        def tick(n):
            return np.random.normal(size=n)  # tvlint: disable=TV003 (test)
    """, "TV003", 1),
    # test_standalone_multiline_suppression_falls_through_comments
    "suppress_standalone_multiline": ("""
        import numpy as np

        def tick(n):
            # tvlint: disable=TV003 (fixture noise is not part of the
            # measured path; determinism is irrelevant here)
            return np.random.normal(size=n)
    """, "TV003", 1),
    # test_suppression_is_rule_specific
    "suppress_rule_specific": ("""
        import numpy as np

        def tick(n):
            return np.random.normal(size=n)  # tvlint: disable=TV001
    """, "TV003", 1),
    # test_tv007_flags_mutable_literal_defaults
    "tv007_mutable_literals": ("""
        def seat(streams=[], weights={}, seen=set()):
            return streams
    """, "TV007", 3),
    # test_tv007_flags_constructed_config_default
    "tv007_constructed_default": ("""
        class SceneConfig:
            pass

        def warm(probe_cfg=SceneConfig()):
            return probe_cfg
    """, "TV007", 1),
    # test_tv007_flags_keyword_only_defaults
    "tv007_keyword_only": ("""
        def plan(*, overrides={"a": 1}):
            return overrides
    """, "TV007", 1),
    # test_tv007_ignores_immutable_defaults
    "tv007_immutable_silent": ("""
        def f(x=None, n=3, name="cam", dims=(1, 2), scale=float("nan"),
              empty=tuple(), frozen=frozenset()):
            return x
    """, "TV007", 0),
}


@pytest.mark.parametrize("case", sorted(SAME))
def test_unchanged_rules_give_the_reference_findings(case):
    src, rule, n = SAME[case]
    ref, port = _ref_lint(src), _lint(src)
    assert _same_fields(port) == _same_fields(ref)
    assert [f.rule for f in port].count(rule) == n


def test_findings_carry_location_axis_and_hint():
    (f,) = _lint(SAME["metadata"][0])
    assert f.rule == "TV003"
    assert f.axis == RULES["TV003"].axis == "data"
    assert f.path == "pkg/mod.py" and f.line > 0 and f.scope == "tick"
    assert f.hint and "generator" in f.hint
    assert f.key.startswith("pkg/mod.py::tick::TV003::")
    assert "pkg/mod.py" in f.render() and "fix:" in f.render()


@pytest.mark.parametrize("case,suppressed", [
    ("suppress_inline", True), ("suppress_standalone_multiline", True),
    ("suppress_rule_specific", False)])
def test_suppression_through_both_linters(case, suppressed):
    for lint in (_lint, _ref_lint):
        (f,) = lint(SAME[case][0])
        assert f.suppressed is suppressed


def test_every_rule_maps_to_a_paper_axis():
    assert {r.axis for r in RULES.values()} == set(AXES)
    assert sorted(RULES) == [f"TV00{i}" for i in range(1, 9)]
    assert AXES == ref_analysis.AXES
    for code, rule in ref_analysis.RULES.items():
        assert (RULES[code].code, RULES[code].axis, RULES[code].title) == \
            (rule.code, rule.axis, rule.title)
        assert "jax" not in RULES[code].hint


def test_exports_cover_the_reference():
    assert set(ref_analysis.__all__) <= set(port_analysis.__all__)
    assert "check" in port_analysis.__all__          # the cert API stays beside them


# ------------------------------------------------ torch-idiom rules ----
# (reference snippet, its torch translation line for line, rule, count of
# that rule: 0 silent, None at least one)

PAIRS = {
    # test_tv001_flags_host_sync_on_traced_value_in_loop
    "tv001_host_sync_in_loop": ("""
        import numpy as np
        import jax
        import jax.numpy as jnp

        def process(frames):
            out = []
            for f in frames:
                y = jnp.tanh(f)
                out.append(np.asarray(y))
            return out
    """, """
        import numpy as np
        import torch
        import torch.nn.functional as F

        def process(frames):
            out = []
            for f in frames:
                y = torch.tanh(f)
                out.append(y.cpu().numpy())
            return out
    """, "TV001", None),
    # test_tv001_flags_item_and_device_get_in_loop
    "tv001_item_and_readback_in_loop": ("""
        import jax
        import jax.numpy as jnp

        def drain_all(queue):
            for dev in queue:
                host = jax.device_get(dev)
            s = jnp.sum(host)
            vals = [s.item() for _ in range(3)]
            return vals
    """, """
        import torch
        from repro_torch.core.timing import to_host

        def drain_all(queue):
            for dev in queue:
                host = to_host(dev)
            s = torch.sum(host)
            vals = [s.item() for _ in range(3)]
            return vals
    """, "TV001", 2),
    # test_tv001_silent_on_single_readback_and_host_arrays
    "tv001_silent_single_readback": ("""
        import numpy as np
        import jax
        import jax.numpy as jnp

        def tick(frames):
            dev = [jnp.tanh(f) for f in frames]
            host = jax.device_get(dev)        # ONE readback, outside loops
            return [np.asarray(h) * 2 for h in host]
    """, """
        import numpy as np
        import torch
        from repro_torch.core.timing import to_host

        def tick(frames):
            dev = [torch.tanh(f) for f in frames]
            host = to_host(dev)               # ONE readback, outside loops
            return [np.asarray(h) * 2 for h in host]
    """, "TV001", 0),
    # test_tv001_block_until_ready_is_a_fence_not_a_hazard
    "tv001_fence_is_no_hazard": ("""
        import jax
        import jax.numpy as jnp

        def run(frames):
            for f in frames:
                y = jnp.tanh(f)
                jax.block_until_ready(y)
            return y
    """, """
        import torch
        from repro_torch.core.timing import fence

        def run(frames):
            for f in frames:
                y = torch.tanh(f)
                fence(y)
            return y
    """, "TV001", 0),
    # test_tv002_flags_jit_inside_loop_and_hot_function
    "tv002_compile_in_loop": ("""
        import jax

        def serve(batches):
            for b in batches:
                f = jax.jit(lambda x: x + 1)
                b = f(b)
            return batches
    """, """
        import torch

        def serve(batches):
            for b in batches:
                f = torch.compile(lambda x: x + 1)
                b = f(b)
            return batches
    """, "TV002", None),
    # test_tv002_flags_jit_lambda_closing_over_loop_var
    "tv002_lambda_over_loop_var": ("""
        import jax

        def build(scales):
            fns = []
            for s in scales:
                fns.append(jax.jit(lambda x: x * s))
            return fns
    """, """
        import torch

        def build(scales):
            fns = []
            for s in scales:
                fns.append(torch.compile(lambda x: x * s))
            return fns
    """, "TV002", 2),
    # test_tv002_flags_python_branch_on_traced_value
    "tv002_branch_on_device_value": ("""
        import jax.numpy as jnp

        def clamp(x):
            y = jnp.sum(x)
            if y > 0:
                return y
            return -y
    """, """
        import torch

        def clamp(x):
            y = torch.sum(x)
            if y > 0:
                return y
            return -y
    """, "TV002", 1),
    # test_tv002_silent_on_shape_branches_and_setup_jit
    "tv002_silent_shape_branches_setup_compile": ("""
        import jax
        import jax.numpy as jnp

        step = jax.jit(lambda x: x + 1)

        def pad_to(x, n):
            if x.shape[0] < n:
                x = jnp.pad(x, (0, n - x.shape[0]))
            while x.ndim < 3:
                x = x[None]
            return x
    """, """
        import torch
        import torch.nn.functional as F

        step = torch.compile(lambda x: x + 1)

        def pad_to(x, n):
            if x.shape[0] < n:
                x = F.pad(x, (0, n - x.shape[0]))
            while x.ndim < 3:
                x = x[None]
            return x
    """, "TV002", 0),
    # test_tv004_flags_donating_call_per_tick: the port's hand-off is a
    # non_blocking copy whose pinned source is rewritten the next iteration
    "tv004_source_rewritten_per_tick": ("""
        import jax

        update = jax.jit(lambda buf, x: buf + x, donate_argnums=(0,))

        def tick(buf, frames):
            for f in frames:
                buf = update(buf, f)
            return buf
    """, """
        import torch

        staging = torch.empty(8, pin_memory=True)

        def tick(buf, frames):
            for f in frames:
                staging.copy_(f); buf.copy_(staging, non_blocking=True)
            return buf
    """, "TV004", 1),
    # test_tv004_silent_on_churn_frequency_donation
    "tv004_silent_single_hand_off": ("""
        import jax

        update = jax.jit(lambda buf, x: buf + x, donate_argnums=(0,))

        def carve_out(buf, frame):
            return update(buf, frame)
    """, """
        import torch

        staging = torch.empty(8, pin_memory=True)

        def carve_out(buf, frame):
            staging.copy_(frame); buf.copy_(staging, non_blocking=True)
    """, "TV004", 0),
    # test_tv005_flags_unjitted_device_fn_in_hot_loop
    "tv005_uncaptured_device_fn": ("""
        import jax.numpy as jnp

        def infer_once(x):
            return jnp.tanh(x @ x)

        def serve(frames):
            return [infer_once(f) for f in frames]
    """, """
        import torch

        def infer_once(x):
            return torch.tanh(x @ x)

        def serve(frames):
            return [infer_once(f) for f in frames]
    """, "TV005", 1),
    # test_tv005_silent_when_jitted_or_traced_under_caller
    "tv005_silent_compiled_or_under_caller": ("""
        import jax
        import jax.numpy as jnp

        def _inner(x):
            return jnp.tanh(x)

        def model_step(x):
            # device-definitional caller: _inner is traced under the
            # caller's jit, not dispatched op-by-op
            for _ in range(3):
                x = _inner(x) + jnp.ones_like(x)
            return x

        step = jax.jit(model_step)

        def serve(frames):
            return [step(f) for f in frames]
    """, """
        import torch
        import torch.nn.functional as F

        def _inner(x):
            return torch.tanh(x)

        def model_step(x):
            # device-definitional caller: _inner runs inside the
            # caller's compiled program, not launched op by op
            for _ in range(3):
                x = _inner(x) + torch.ones_like(x)
            return x

        step = torch.compile(model_step)

        def serve(frames):
            return [step(f) for f in frames]
    """, "TV005", 0),
    # test_tv005_silent_on_factory_handed_to_jit
    "tv005_silent_factory_handed_to_compile": ("""
        import jax
        import jax.numpy as jnp

        def make_runner(scale):
            def f(x):
                return jnp.tanh(x) * scale
            return f

        def build_step(scale):
            step_fn = make_runner(scale)
            return jax.jit(step_fn)
    """, """
        import torch
        import torch.nn.functional as F

        def make_runner(scale):
            def f(x):
                return torch.tanh(x) * scale
            return f

        def build_step(scale):
            step_fn = make_runner(scale)
            return torch.compile(step_fn)
    """, "TV005", 0),
    # test_tv006_flags_unfenced_interval_around_jitted_call
    "tv006_unfenced_interval": ("""
        import time
        import jax

        predict = jax.jit(lambda x: x + 1)

        def measure(x):
            t0 = time.perf_counter()
            y = predict(x)
            dt = time.perf_counter() - t0
            return y, dt
    """, """
        import time
        import torch

        predict = torch.compile(lambda x: x + 1)

        def measure(x):
            t0 = time.perf_counter()
            y = predict(x)
            dt = time.perf_counter() - t0
            return y, dt
    """, "TV006", 1),
    # test_tv006_silent_when_fenced
    "tv006_silent_when_fenced": ("""
        import time
        import jax

        predict = jax.jit(lambda x: x + 1)

        def measure(x):
            t0 = time.perf_counter()
            y = predict(x)
            jax.block_until_ready(y)
            dt = time.perf_counter() - t0
            return y, dt
    """, """
        import time
        import torch

        predict = torch.compile(lambda x: x + 1)

        def measure(x):
            t0 = time.perf_counter()
            y = predict(x)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            return y, dt
    """, "TV006", 0),
    # test_tv001_via_helper_that_syncs_its_parameter
    "tv001_via_helper": ("""
        import numpy as np
        import jax.numpy as jnp

        def to_host(x):
            return np.asarray(x)

        def serve(frames):
            out = []
            for f in frames:
                y = jnp.tanh(f)
                out.append(to_host(y))
            return out
    """, """
        import numpy as np
        import torch

        def to_host(x):
            return x.cpu().numpy()

        def serve(frames):
            out = []
            for f in frames:
                y = torch.tanh(f)
                out.append(to_host(y))
            return out
    """, "TV001", 1),
    # test_tv001_via_helper_clean_on_host_values
    "tv001_via_helper_silent_on_host": ("""
        import numpy as np
        import jax.numpy as jnp

        def to_host(x):
            return np.asarray(x)

        def serve(frames):
            out = []
            for f in frames:
                g = np.square(f)
                out.append(to_host(g))
            return out
    """, """
        import numpy as np
        import torch

        def to_host(x):
            return x.cpu().numpy()

        def serve(frames):
            out = []
            for f in frames:
                g = np.square(f)
                out.append(to_host(g))
            return out
    """, "TV001", 0),
    # test_tv002_via_helper_that_jits_in_its_body
    "tv002_via_helper": ("""
        import jax

        def make_runner(scale):
            return jax.jit(lambda x: x * scale)

        def tick(xs):
            fn = make_runner(2.0)
            return [fn(x) for x in xs]
    """, """
        import torch

        def make_runner(scale):
            return torch.compile(lambda x: x * scale)

        def tick(xs):
            fn = make_runner(2.0)
            return [fn(x) for x in xs]
    """, "TV002", 1),
    # test_tv002_via_helper_clean_at_setup_time
    "tv002_via_helper_silent_at_setup": ("""
        import jax

        def make_runner(scale):
            return jax.jit(lambda x: x * scale)

        def build(scale):
            return make_runner(scale)
    """, """
        import torch

        def make_runner(scale):
            return torch.compile(lambda x: x * scale)

        def build(scale):
            return make_runner(scale)
    """, "TV002", 0),
    # test_tv005_via_one_hop_wrapper
    "tv005_via_wrapper": ("""
        import jax.numpy as jnp

        def normalize(x):
            return x / jnp.maximum(jnp.abs(x).max(), 1e-6)

        def postprocess(x):
            return normalize(x)

        def tick(frames):
            return [postprocess(f) for f in frames]
    """, """
        import torch

        def normalize(x):
            return x / torch.clamp(torch.abs(x).max(), min=1e-6)

        def postprocess(x):
            return normalize(x)

        def tick(frames):
            return [postprocess(f) for f in frames]
    """, "TV005", 1),
    # test_tv005_via_clean_when_callee_is_jitted
    "tv005_via_silent_when_callee_compiled": ("""
        import jax
        import jax.numpy as jnp

        def normalize(x):
            return x / jnp.maximum(jnp.abs(x).max(), 1e-6)

        normalize_fast = jax.jit(normalize)

        def postprocess(x):
            return normalize(x)

        def tick(frames):
            return [postprocess(f) for f in frames]
    """, """
        import torch
        import torch.nn.functional as F

        def normalize(x):
            return x / torch.clamp(torch.abs(x).max(), min=1e-6)

        normalize_fast = torch.compile(normalize)

        def postprocess(x):
            return normalize(x)

        def tick(frames):
            return [postprocess(f) for f in frames]
    """, "TV005", 0),
}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_torch_rules_match_the_reference_on_translations(case):
    ref_src, torch_src, rule, n = PAIRS[case]
    assert len(textwrap.dedent(ref_src).splitlines()) == \
        len(textwrap.dedent(torch_src).splitlines())
    ref, port = _ref_lint(ref_src), _lint(torch_src)
    assert _triples(port) == _triples(ref)
    assert _vias(port) == _vias(ref)
    count = [f.rule for f in port].count(rule)
    assert count >= 1 if n is None else count == n


# ------------------------------------------- torch-only idioms ---------
# (snippet, rule, expected count)

TORCH_ONLY = {
    "tv001_tolist_and_numpy_in_loop": ("""
        import torch

        def collect(xs):
            return [torch.relu(x).tolist() for x in xs] + [torch.relu(x).numpy() for x in xs]
    """, "TV001", 2),
    "tv001_float_of_device_value_in_loop": ("""
        import torch

        def losses(batches, w):
            return [float(torch.mean(b @ w)) for b in batches]
    """, "TV001", 1),
    "tv001_fenced_value_is_device": ("""
        from repro_torch.core.timing import fence

        def generate(step, cur, n):
            for _ in range(n):
                nxt = step(cur)
                fence(nxt)
                cur = nxt.item()
            return cur
    """, "TV001", 1),
    "tv002_graph_capture_in_tick": ("""
        import torch

        def tick(fn, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = fn(x)
            g.replay()
            return y
    """, "TV002", 2),
    "tv002_silent_capture_at_setup": ("""
        import torch

        def capture(fn, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = fn(x)
            return g, y
    """, "TV002", 0),
    "tv002_silent_on_device_and_identity_tests": ("""
        import torch

        def route(x: torch.Tensor, lse: torch.Tensor = None, aux: dict = None):
            if lse is None:
                lse = torch.zeros(1)
            if x.device.type == "cuda" and x.is_cuda:
                x = x.float()
            y = torch.sum(x)
            if "k" in aux:
                return y
            return x
    """, "TV002", 0),
    "tv002_branch_on_annotated_tensor": ("""
        import torch

        def gate(x: torch.Tensor):
            return x if x.max() > 0 else -x
    """, "TV002", 1),
    "tv003_global_torch_generator": ("""
        import torch

        def noise(n, w):
            a = torch.randn(n)
            b = torch.randint(0, 4, (n,))
            w.normal_()
            return a, b
    """, "TV003", 3),
    "tv003_silent_with_generator": ("""
        import torch

        def noise(n, w, seed):
            g = torch.Generator().manual_seed(seed)
            a = torch.randn(n, generator=g)
            w.normal_(0.0, 1.0, generator=g)
            torch.manual_seed(seed)
            return a
    """, "TV003", 0),
    "tv003_wall_clock_torch_seed": ("""
        import time
        import torch

        def fresh(n):
            torch.manual_seed(int(time.time()))
            g = torch.Generator().manual_seed(time.time_ns())
            torch.seed()
            return g
    """, "TV003", 3),
    "tv004_silent_after_event_fence": ("""
        import torch

        staging = torch.empty(8, pin_memory=True)

        def tick(buf, frames, event):
            for f in frames:
                event.synchronize()
                staging.copy_(f); buf.copy_(staging, non_blocking=True); event.record()
            return buf
    """, "TV004", 0),
    "tv004_destination_read_before_fence": ("""
        import torch

        def readback(dev):
            host = dev.to("cpu", non_blocking=True)
            return host.numpy()
    """, "TV004", 1),
    "tv004_silent_destination_read_after_fence": ("""
        import torch

        def readback(dev):
            host = dev.to("cpu", non_blocking=True)
            torch.cuda.current_stream().synchronize()
            return host.numpy()
    """, "TV004", 0),
    "tv004_pinned_destination_read_before_fence": ("""
        import torch

        def drain(dev, n):
            out = torch.empty(n, pin_memory=True)
            out.copy_(dev, non_blocking=True)
            return out.sum()
    """, "TV004", 1),
    "tv005_silent_when_handed_to_executor": ("""
        import torch
        from repro_torch.batched import PipelinedExecutor

        def infer(raw):
            return torch.relu(raw)

        def serve(frames):
            ex = PipelinedExecutor(infer, 4, (8, 8, 3))
            return [infer(f) for f in frames]
    """, "TV005", 0),
    "tv005_silent_when_captured_in_a_graph": ("""
        import torch

        def infer(raw):
            return torch.relu(raw)

        def serve(g, frames):
            with torch.cuda.graph(g):
                out = infer(frames[0])
            return [infer(f) for f in frames]
    """, "TV005", 0),
    "tv006_unfenced_method_launch": ("""
        import time
        import torch

        class Runner:
            def _launch(self, x):
                return torch.relu(x)

            def submit(self, x):
                t0 = time.perf_counter()
                y = self._launch(x)
                return y, time.perf_counter() - t0
    """, "TV006", 1),
    "tv006_silent_with_event_or_span_fences": ("""
        import time
        import torch

        def measure(x, start, end, tracer):
            t0 = time.perf_counter()
            y = torch.relu(x)
            ms = start.elapsed_time(end)
            dt = time.perf_counter() - t0
            t1 = time.perf_counter()
            with tracer.span("step", fence=lambda: y):
                y = torch.relu(y)
            return y, dt, time.perf_counter() - t1, ms
    """, "TV006", 0),
}


@pytest.mark.parametrize("case", sorted(TORCH_ONLY))
def test_torch_only_idioms(case):
    src, rule, n = TORCH_ONLY[case]
    assert [f.rule for f in _lint(src) if not f.suppressed].count(rule) == n


# ------------------------------------------- determinism / stability --

HAZARD_SRC = """\
import numpy as np
import torch


def serve(frames):
    out = []
    for f in frames:
        y = torch.tanh(f)
        out.append(np.asarray(y))
    return out


def reseed(n):
    return np.random.default_rng()
"""


@pytest.mark.parametrize("lint", [lint_source, ref_lint_source], ids=["port", "reference"])
def test_lint_output_is_deterministic(lint):
    a = report_dict(lint(HAZARD_SRC, "m.py"))
    b = report_dict(lint(HAZARD_SRC, "m.py"))
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_both_linters_key_the_shared_rule_alike():
    port = {f.key for f in lint_source(HAZARD_SRC, "m.py")}
    ref = {f.key for f in ref_lint_source(HAZARD_SRC, "m.py")}
    assert ref and ref <= port                                # TV003: the same keys
    assert [f.rule for f in lint_source(HAZARD_SRC, "m.py")] == ["TV001", "TV003"]


def _reformat(src: str, rng: np.random.Generator) -> str:
    """Formatting-only edit: sprinkle blank lines and comment lines at
    random positions (never inside a continuation)."""
    lines = src.splitlines()
    out = []
    for line in lines:
        while rng.random() < 0.3:
            out.append("" if rng.random() < 0.5
                       else " " * (len(line) - len(line.lstrip()))
                       + "# a formatting-only comment")
        out.append(line)
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("lint", [lint_source, ref_lint_source], ids=["port", "reference"])
def test_finding_keys_stable_under_formatting_only_edits(lint):
    base = {f.key for f in lint(HAZARD_SRC, "m.py")}
    assert base
    rng = np.random.default_rng(0)
    for _ in range(25):
        assert {f.key for f in lint(_reformat(HAZARD_SRC, rng), "m.py")} == base


@pytest.mark.parametrize("lint,old,new", [
    (lint_source, "np.asarray(y)", "np.asarray(y * 2)"),
    (lint_source, "np.random.default_rng()", "np.random.default_rng(*())"),
    (ref_lint_source, "np.random.default_rng()", "np.random.default_rng(*())"),
], ids=["port-tv001", "port-tv003", "reference-tv003"])
def test_finding_keys_change_when_hazard_statement_changes(lint, old, new):
    base = {f.key for f in lint(HAZARD_SRC, "m.py")}
    assert {f.key for f in lint(HAZARD_SRC.replace(old, new), "m.py")} != base


def test_tv006_key_fingerprints_the_closing_statement():
    """The port keys a TV006 finding on the statement that closes the
    interval; the reference keys it on the statement around the function
    (for a method, the whole class), so an unrelated edit to the class
    moves the reference's key but not the port's."""
    src = textwrap.dedent("""\
        import time
        import {mod}

        predict = {wrap}(lambda x: x + 1)

        class Runner:
            def measure(self, x):
                t0 = time.perf_counter()
                y = predict(x)
                return y, time.perf_counter() - t0
    """)
    sibling = "\n    def other(self):\n        return 1\n"
    port = src.format(mod="torch", wrap="torch.compile")
    ref = src.format(mod="jax", wrap="jax.jit")
    keys = [{f.key for f in lint(text, "m.py")}
            for lint, base in ((lint_source, port), (ref_lint_source, ref))
            for text in (base, base + sibling)]
    assert keys[0] == keys[1] and len(keys[0]) == 1
    assert keys[2] != keys[3] and len(keys[2]) == 1


# ------------------------------------------------- baseline diff ------

def test_baseline_accepts_known_and_flags_new(tmp_path):
    findings = lint_source(HAZARD_SRC, "m.py")
    bl_path = tmp_path / "baseline.json"
    write_baseline(findings, bl_path)
    baseline = load_baseline(bl_path)
    assert diff_baseline(findings, baseline) == ([], [])
    # a fresh hazard not in the baseline is new
    edited = HAZARD_SRC + "\n\ndef tick(n):\n    return torch.rand(n)\n"
    new2, _ = diff_baseline(lint_source(edited, "m.py"), baseline)
    assert [f.rule for f in new2] == ["TV003"]
    # fixing a baselined hazard leaves a stale entry, not a failure
    fixed = HAZARD_SRC.replace("np.random.default_rng()", "np.random.default_rng(0)")
    new3, stale3 = diff_baseline(lint_source(fixed, "m.py"), baseline)
    assert new3 == [] and len(stale3) == 1
    # the shared rule's entries are the reference's, byte for byte
    ref_path = tmp_path / "ref.json"
    ref_analysis.write_baseline(ref_lint_source(HAZARD_SRC, "m.py"), ref_path)
    write_baseline([f for f in findings if f.rule == "TV003"], bl_path)
    assert bl_path.read_text() == ref_path.read_text()
    # an unknown version is refused
    bl_path.write_text(json.dumps({"version": 2, "entries": {}}))
    with pytest.raises(ValueError, match="version"):
        load_baseline(bl_path)


# ------------------------------------------------- CLI / gate ---------

def _copy_engine_tree(tmp_path: Path) -> Path:
    """Replicate src/repro_torch/batched/engine.py under a scratch root so
    finding keys match the committed baseline's relative paths."""
    root = tmp_path / "src"
    dest = root / "repro_torch" / "batched"
    dest.mkdir(parents=True)
    shutil.copyfile(REPO / "src" / "repro_torch" / "batched" / "engine.py", dest / "engine.py")
    return root


def test_cli_baseline_gate_passes_on_clean_tree_and_fails_on_injection(tmp_path, capsys):
    root = _copy_engine_tree(tmp_path)
    baseline = str(TORCH_BASELINE)
    target = root / "repro_torch" / "batched" / "engine.py"
    args = [str(root / "repro_torch"), "--baseline", baseline]

    # the shipped engine.py is hazard-free against the committed baseline
    # (and the default root is the parent of a path named repro_torch)
    assert tvlint_main(args) == 0

    # a TV002 capture hazard (torch.compile in a per-tick loop) fails the
    # gate although the baseline file itself is untouched
    target.write_text(target.read_text() + textwrap.dedent("""

        def _injected_tick(xs):
            for x in xs:
                f = torch.compile(lambda v: v + 1)
                x = f(x)
            return xs
    """))
    assert tvlint_main(args) == 1
    assert "TV002" in capsys.readouterr().out

    # and a TV001 host sync (.item() of a device value in a loop) the same way
    target.write_text(target.read_text() + textwrap.dedent("""

        def _injected_drain(devs):
            return [torch.tanh(d).item() for d in devs]
    """))
    assert tvlint_main(args) == 1
    assert "TV001" in capsys.readouterr().out


def test_cli_exit_codes_and_regen(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text("import torch\n\n"
                   "def tick(n):\n    return torch.rand(n)\n")
    # findings without a baseline: exit 1
    assert tvlint_main([str(mod), "--root", str(tmp_path)]) == 1
    # missing path: exit 2
    assert tvlint_main([str(tmp_path / "nope.py")]) == 2
    # missing baseline file: exit 2
    assert tvlint_main([str(mod), "--root", str(tmp_path),
                        "--baseline", str(tmp_path / "none.json")]) == 2
    # --regen-baseline without --baseline: exit 2
    assert tvlint_main([str(mod), "--root", str(tmp_path), "--regen-baseline"]) == 2
    # regen writes the baseline; the gate then passes and the report
    # carries the finding inventory
    bl = tmp_path / "bl.json"
    rep = tmp_path / "report.json"
    assert tvlint_main([str(mod), "--root", str(tmp_path),
                        "--baseline", str(bl), "--regen-baseline"]) == 0
    assert tvlint_main([str(mod), "--root", str(tmp_path),
                        "--baseline", str(bl), "--report", str(rep)]) == 0
    data = json.loads(rep.read_text())
    assert data["active"] == 1
    assert data["by_rule"] == {"TV003": 1}


def test_shipped_tree_is_lint_clean(regen_baseline):
    """The acceptance gate itself: the port has no hazards beyond its
    committed baseline.  ``--regen-baseline`` (or ``--regen-fixtures``)
    rewrites analysis/torch_baseline.json instead."""
    args = [str(REPO / "src" / "repro_torch"),
            "--root", str(REPO / "src"),
            "--baseline", str(TORCH_BASELINE),
            "--quiet"]
    if regen_baseline:
        args.append("--regen-baseline")
    assert tvlint_main(args) == 0


def test_shipped_tree_suppresses_the_reference_intentional_sites():
    """The port's counterparts of the reference's intentional hazards carry
    the same suppression, and no active finding is a mutable default."""
    findings = lint_paths([REPO / "src" / "repro_torch"], REPO / "src")
    suppressed = {(f.path, f.rule) for f in findings if f.suppressed}
    assert suppressed == {("repro_torch/runtime/engine.py", "TV001"),
                          ("repro_torch/batched/executor.py", "TV006"),
                          ("repro_torch/analysis/cert/certificate.py", "TV005")}
    assert not [f for f in findings if f.rule == "TV007" and not f.suppressed]


# ------------------------------------------------- TraceSentinel ------

def _executor():
    return PipelinedExecutor(lambda raw: raw.sum(dim=(1, 2, 3)), 2, (4, 4, 3), device="cpu")


def _frame(v: float = 1.0) -> np.ndarray:
    return np.full((4, 4, 3), v, np.float32)


def test_sentinel_counts_builds_and_enforces_budget():
    ex = _executor()
    with pytest.raises(TimingHazardError):
        with TraceSentinel(compile_budget=0, transfer_guard="allow"):
            ex.warmup()
    assert ex.step_captures == 1

    ex2 = _executor()
    before = ex2.step_captures
    with TraceSentinel(compile_budget=1, transfer_guard="allow") as sent:
        ex2.warmup()
    rep = sent.report()
    assert rep.compiles == ex2.step_captures - before == 1
    assert rep.traces == 1                   # the CPU build's one eager run


def test_sentinel_warm_path_is_compile_free():
    ex = _executor()
    ex.warmup()
    with TraceSentinel(compile_budget=0) as sent:
        for t in range(5):
            ex.submit({0: _frame(t)})
            ex.drain()
    rep = sent.report()
    assert rep.compiles == 0 and rep.ok and isinstance(rep, SentinelReport)
    assert "compiles=0/0" in rep.render()
    assert ex.step_replays == 5


def test_sentinel_non_strict_reports_instead_of_raising():
    with TraceSentinel(compile_budget=0, transfer_guard="allow", strict=False) as sent:
        _executor().warmup()
    rep = sent.report()
    assert rep.compiles >= 1 and not rep.ok
    assert set(rep.to_dict()) == {"compiles", "traces", "compile_budget", "trace_budget",
                                  "transfer_guard", "ok"}
    with pytest.raises(TimingHazardError):
        sent.check()


def test_sentinel_trace_budget_and_guard_levels():
    with TraceSentinel(compile_budget=1, trace_budget=0, transfer_guard="log",
                       strict=False) as sent:
        _executor().warmup()
    assert (sent.report().traces, sent.report().ok) == (1, False)
    assert SYNC_DEBUG_MODES == {"allow": "default", "log": "warn", "disallow": "error"}
    with pytest.raises(ValueError, match="transfer_guard"):
        TraceSentinel(transfer_guard="forbid")
    # without CUDA there is nothing to guard and nothing is armed
    if not torch.cuda.is_available():
        with TraceSentinel() as sent:
            assert sent._prev_mode is None


def test_sentinel_records_builds_as_runtime_spans():
    from repro_torch.bus import SimClock
    from repro_torch.obs import SpanTracer

    clock = SimClock()
    tr = SpanTracer(capacity=16, clock=clock.time)
    with TraceSentinel(compile_budget=1, transfer_guard="allow", tracer=tr) as sent:
        _executor().warmup()
    assert sent.report().compiles == 1
    builds = [s for s in tr.spans() if s.name == "backend_compile"]
    assert len(builds) == 1
    assert builds[0].axis == "runtime" and builds[0].duration >= 0.0


def test_sentinel_without_tracer_stays_silent():
    with TraceSentinel(compile_budget=1, transfer_guard="allow") as sent:
        _executor().warmup()
    assert sent.tracer is None
    assert sent.report().compiles == 1


def test_every_build_site_reports_its_build():
    """The executor's build and the multi-tenant engine's warm-up both fire
    one BUILD_EVENT; a listener sees them with their durations."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.runtime import MultiTenantConfig, MultiTenantEngine

    seen = []
    monitoring.register_event_duration_secs_listener(
        lambda event, duration, **kw: seen.append((event, duration)))
    _executor().warmup()
    cfg = get_config("qwen3-4b", smoke=True)
    model = Model(cfg)
    eng = MultiTenantEngine(model, model.init(seed=0, device="cpu"),
                            MultiTenantConfig(capacity=2, context=16), device="cpu")
    with TraceSentinel(compile_budget=1, transfer_guard="allow") as sent:
        eng.compile()
    assert sent.report().compiles == 1 and eng.trace_count == 1
    builds = [d for e, d in seen if e == monitoring.BUILD_EVENT]
    assert len(builds) == 2 and all(d >= 0.0 for d in builds)


# --------------------------------------- sentinel on the replay path --

@pytest.fixture(scope="module")
def golden_sched():
    """One CPU scheduler (port's seed-7 weights) and its plain replay."""
    from repro_torch.scenarios import golden_replay

    plain, sched = golden_replay("urban_rush_hour", device="cpu")
    return plain, sched


def test_sentinel_wrapped_golden_episode_is_clean_and_byte_identical(golden_sched):
    """A sentinel-wrapped golden episode sees zero builds after warm-up,
    and the report is byte-identical to an unguarded run."""
    from repro_torch.scenarios import golden_replay

    plain, sched = golden_sched
    sent = TraceSentinel(compile_budget=0, transfer_guard="disallow")
    guarded, _ = golden_replay("urban_rush_hour", scheduler=sched, sentinel=sent)
    rep = sent.report()
    assert rep.compiles == 0 and rep.ok
    assert guarded.to_json(indent=2) == plain.to_json(indent=2)


def test_replayer_hands_the_episode_tracer_to_the_sentinel(golden_sched):
    """As the reference's ``ScenarioReplayer.run``: a sentinel without a
    tracer gets the observatory's, so builds land on the episode timeline."""
    from repro_torch.obs import Observatory
    from repro_torch.scenarios import ScenarioReplayer, compile_trace, get_episode

    _, sched = golden_sched
    # a short cut of the episode: the hand-off happens before the first tick
    trace = compile_trace(get_episode("urban_rush_hour"), seed=3, tick_scale=0.1)
    obs = Observatory()
    sent = TraceSentinel(compile_budget=0, transfer_guard="allow")
    ScenarioReplayer(trace, scheduler=sched, obs=obs).run(sentinel=sent)
    assert sent.tracer is obs.tracer
    assert sent.report().compiles == 0
    # a sentinel that brings its own tracer keeps it
    own = TraceSentinel(compile_budget=0, transfer_guard="allow", tracer=obs.tracer)
    ScenarioReplayer(trace, scheduler=sched).run(sentinel=own)
    assert own.tracer is obs.tracer
