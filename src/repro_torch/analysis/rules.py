"""AST rules for the port's ``tvlint``: static detection of the PyTorch and
CUDA code patterns that produce DNN inference-time variation.  The port of
the reference's ``repro/analysis/rules.py``, with each rule re-derived for
torch idioms.

The analyzer is deliberately *module-local and heuristic*, as the
reference's: it resolves import aliases, tracks which local names hold
device values and which hold compiled or captured callables, and flags
hazardous uses in **hot contexts** (syntactic loops — ``for``/``while``/
comprehensions — and functions whose names mark them as per-tick entry
points).  Within a module it is **one level interprocedural**: a prepass
summarizes each local helper (does it host-sync a parameter?  capture or
compile in its body?  reach device math through one plain-name hop?) so
TV001/TV002/TV005 follow the hazard through a single helper call and
report at the *call site* with a ``via <helper>`` note.  It does not chase
values across modules; cross-module invariants are the runtime
``TraceSentinel``'s job.  Intentional patterns are silenced with an inline
``# tvlint: disable=TVxxx`` comment (with the reason in the comment);
accepted debt lives in the committed baseline.

A *device value* is a name bound from a ``torch.*`` or
``torch.nn.functional.*`` call (``torch.from_numpy`` and the non-math
helpers excepted), from a call of a module built by ``torch.nn.<Module>``,
a compiled callable, ``.to(device)``/``.cuda()``, one of the port's device
methods (``_DEVICE_ATTR_CALLS``), or a tensor method of another device
value; a parameter annotated ``torch.Tensor`` is one too.

Rules (axis in brackets):

* **TV001 [io]** — host sync on a device value inside a loop:
  ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``, ``float()``/
  ``int()``/``bool()``, ``np.asarray``/``np.array`` of a device value, or
  ``core.timing.to_host`` inside a per-iteration loop body (one readback
  per iteration instead of one per tick).  Fences
  (``torch.cuda.synchronize``, ``Event``/``Stream.synchronize``,
  ``core.timing.fence``) are not hazards.
* **TV002 [runtime]** — capture/compile hazards: ``torch.compile``,
  ``torch.cuda.CUDAGraph()``, ``torch.cuda.graph(...)`` or
  ``torch.cuda.make_graphed_callables`` in a loop or per-tick function,
  ``torch.compile`` of a lambda closing over an enclosing loop variable,
  and Python ``if``/``while``/``assert``/ternary branching on a device
  value (``.shape``/``.dtype``/``.ndim``/``.device`` are static).
* **TV003 [data]** — nondeterministic randomness: the reference's
  patterns unchanged (legacy global-state ``np.random.*`` calls,
  ``np.random.default_rng()`` with no seed, stdlib ``random.*`` draws,
  wall-clock time feeding a seed or key), plus torch's global generator:
  ``torch.rand``/``randn``/``randint``/``randperm``/``normal``/
  ``bernoulli``/``multinomial`` (and the ``*_like`` draws) or an in-place
  ``.uniform_()``/``.normal_()``… with no ``generator=``, ``torch.seed()``,
  and wall-clock time fed to ``torch.manual_seed`` or a generator's
  ``.manual_seed``.
* **TV004 [hardware]** — async hand-off misuse, the port's counterpart of
  donation: (a) a host buffer that is the source of a ``non_blocking=True``
  copy is written again in a hot context with no event or stream fence in
  between (the copy may still be reading it), and (b) the host
  destination of a ``non_blocking=True`` device-to-host copy is read
  before such a fence (it may not hold the data yet).  Host destinations
  are names bound with ``pin_memory=True``/``.pin_memory()`` or results
  of ``.to("cpu", non_blocking=True)``/``.cpu(non_blocking=True)``.
* **TV005 [model]** — a module-local function that performs torch device
  math, invoked in a hot context, that is never captured in a CUDA graph,
  never ``torch.compile``d and never handed to a capturing executor
  (``PipelinedExecutor``) as its ``step_fn``: per-tick op-by-op launches.
* **TV006 [end_to_end]** — a ``time.perf_counter()``/``time.time()``
  interval closed after a device call with no fence in between: the
  number measures the launch, not the work.  Fences are those of TV001,
  ``core.timing.to_host``, ``Event.elapsed_time``, and a
  ``with tracer.span(..., fence=...)`` block (the obs layer's fenced
  timing site).
* **TV007 [data]** — a mutable default argument (the reference's rule,
  unchanged).
* **TV008 [runtime]** — fault swallowing in a hot context (the
  reference's rule, unchanged).
"""
from __future__ import annotations

import ast
import hashlib
import re
from typing import Optional

from .findings import RULES, Finding

__all__ = ["HOT_FUNCTION_RE", "analyze_module"]

# function names treated as per-tick entry points even outside loops
HOT_FUNCTION_RE = re.compile(
    r"(^|_)(tick|step|submit|drain|serve|decode)(_|$)|^run_frame$"
)

# torch namespaces whose every call is device math
_DEVICE_NS = ("torch.nn.functional.", "torch.special.", "torch.linalg.", "torch.fft.",
              "torch.ops.")
# top-level torch.<fn> calls that are no device math: objects, modes,
# seeds, compilers, and host views
_TORCH_NOT_MATH = {
    "device", "dtype", "finfo", "iinfo", "no_grad", "inference_mode", "enable_grad",
    "set_grad_enabled", "is_grad_enabled", "is_tensor", "is_floating_point",
    "is_complex", "get_default_dtype", "set_default_dtype", "manual_seed", "seed",
    "initial_seed", "get_rng_state", "set_rng_state", "compile", "from_numpy",
    "use_deterministic_algorithms", "set_printoptions", "set_num_threads",
    "get_num_threads", "load", "save",
}
# methods of the port's objects that run device math and return device values
_DEVICE_ATTR_CALLS = {"infer", "infer_device", "apply", "static_fit_device", "device_step",
                      "forward", "prefill", "decode_step"}
# tensor methods whose result is host data or metadata, not a device value
_HOST_METHODS = {"item", "tolist", "cpu", "numpy", "size", "dim", "numel", "nelement",
                 "element_size", "stride", "data_ptr", "is_contiguous", "get_device",
                 "synchronize", "query", "record", "elapsed_time", "pin_memory"}
_SYNC_CALLS = {"numpy.asarray", "numpy.array", "numpy.ascontiguousarray",
               "float", "int", "bool"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# the port's one-readback-per-tick helper (core.timing.to_host), the
# counterpart of jax.device_get
_READBACK_SUFFIXES = ("core.timing.to_host", "core.to_host")
_FENCE_CALLS = {"torch.cuda.synchronize"}
_FENCE_SUFFIXES = ("core.timing.fence", "core.fence")
_FENCE_METHODS = {"synchronize", "elapsed_time"}
_CLOCK_CALLS = {"time.perf_counter", "time.time", "time.monotonic",
                "time.time_ns"}
# callable wrappers whose result is compiled or graph-captured
_COMPILE_WRAPPERS = {"torch.compile", "torch.cuda.make_graphed_callables",
                     "torch.cuda.graphs.make_graphed_callables", "torch.jit.script",
                     "torch.jit.trace"}
# graph objects and the capture context manager
_GRAPH_CALLS = {"torch.cuda.CUDAGraph", "torch.cuda.graph", "torch.cuda.graphs.CUDAGraph",
                "torch.cuda.graphs.graph"}
_CAPTURE_CALLS = _COMPILE_WRAPPERS | _GRAPH_CALLS
_CAPTURE_CTX = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
# an executor that captures the step_fn it is given (batched/executor.py)
_CAPTURING_EXECUTOR = "PipelinedExecutor"
_GLOBAL_NP_RANDOM = {
    "seed", "random", "rand", "randn", "randint", "random_sample", "ranf",
    "sample", "normal", "uniform", "choice", "shuffle", "permutation",
    "poisson", "exponential", "lognormal", "beta", "gamma", "binomial",
    "standard_normal",
}
_STDLIB_RANDOM = {
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "expovariate", "seed",
}
_SEEDED_SINKS = {"numpy.random.default_rng", "jax.random.PRNGKey",
                 "jax.random.key", "numpy.random.seed", "random.seed",
                 "torch.manual_seed", "torch.cuda.manual_seed",
                 "torch.cuda.manual_seed_all", "torch.random.manual_seed"}
# torch draws from the process-wide generator unless given generator=
_TORCH_GLOBAL_DRAWS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
                       "multinomial", "poisson", "rand_like", "randn_like", "randint_like"}
_TORCH_INPLACE_DRAWS = {"uniform_", "normal_", "random_", "exponential_", "bernoulli_",
                        "cauchy_", "log_normal_", "geometric_"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "sharding", "itemsize", "device",
                 "is_cuda", "layout", "requires_grad", "is_sparse"}
_DEVICE_ANNOTATIONS = {"torch.Tensor"}
# constructor calls allowed in parameter defaults: they build immutable
# values, so sharing the def-time instance is harmless
_IMMUTABLE_DEFAULT_CALLS = {
    "tuple", "frozenset", "int", "float", "str", "bytes", "bool", "complex",
}
_MUTABLE_DISPLAYS = (ast.List, ast.Dict, ast.Set,
                     ast.ListComp, ast.DictComp, ast.SetComp)
_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)


def _dotted(node: ast.AST, aliases: dict[str, str]) -> Optional[str]:
    """Resolve an attribute chain to a canonical dotted name, mapping the
    leading identifier through the module's import aliases."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(aliases.get(node.id, node.id))
        return ".".join(reversed(parts))
    return None


def _collect_aliases(tree: ast.Module) -> dict[str, str]:
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _fingerprint(stmt: ast.stmt) -> str:
    """Formatting-stable statement identity: ``ast.dump`` carries no
    line/column attributes, so blank lines and comments cannot move it."""
    return hashlib.sha1(ast.dump(stmt).encode()).hexdigest()[:12]


def _ends_with(d: Optional[str], suffixes: tuple[str, ...]) -> bool:
    """``d`` is one of ``suffixes`` or ends with ``.<suffix>`` (relative
    imports resolve to ``core.timing.x``, absolute ones to
    ``repro_torch.core.timing.x``)."""
    return d is not None and any(d == s or d.endswith("." + s) for s in suffixes)


def _is_torch_math(d: Optional[str]) -> bool:
    """A torch call that computes on tensors (device math)."""
    if d is None or not d.startswith("torch."):
        return False
    if d.startswith(_DEVICE_NS):
        return True
    leaf = d[len("torch."):]
    return "." not in leaf and leaf[:1].islower() and leaf not in _TORCH_NOT_MATH


def _is_fence(call: ast.Call, aliases: dict[str, str]) -> bool:
    """A host wait for device work: ``torch.cuda.synchronize``,
    ``core.timing.fence``/``to_host``, ``<event or stream>.synchronize()``
    or ``<event>.elapsed_time()``."""
    d = _dotted(call.func, aliases)
    if d in _FENCE_CALLS or _ends_with(d, _FENCE_SUFFIXES) or _ends_with(d, _READBACK_SUFFIXES):
        return True
    return isinstance(call.func, ast.Attribute) and call.func.attr in _FENCE_METHODS


def _kw(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _non_blocking(call: ast.Call) -> bool:
    v = _kw(call, "non_blocking")
    return isinstance(v, ast.Constant) and v.value is True


def _to_cpu(call: ast.Call) -> bool:
    """``x.cpu(...)`` or ``x.to("cpu"...)``/``x.to(device="cpu")``."""
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr == "cpu":
        return True
    if call.func.attr != "to":
        return False
    target = call.args[0] if call.args else _kw(call, "device")
    return (isinstance(target, ast.Constant) and isinstance(target.value, str)
            and target.value.startswith("cpu"))


def _buf_key(node: ast.AST) -> Optional[str]:
    """Identity of a buffer expression: its attribute chain with subscripts
    and slices stripped (``self.stage[r][a:b]`` -> ``self.stage``)."""
    while isinstance(node, (ast.Subscript, ast.Starred)):
        node = node.value
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _pins(value: ast.AST) -> bool:
    """An expression that allocates pinned host memory."""
    for sub in ast.walk(value):
        if isinstance(sub, ast.Call):
            pin = _kw(sub, "pin_memory")
            if isinstance(pin, ast.Constant) and pin.value is True:
                return True
            if isinstance(sub.func, ast.Attribute) and sub.func.attr == "pin_memory":
                return True
    return False


def _walk_local(node: ast.AST):
    """``ast.walk`` that does not enter nested functions, classes or
    lambdas (their bodies run at another time)."""
    todo = [node]
    while todo:
        n = todo.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if not isinstance(child, _SCOPES):
                todo.append(child)


class _ModuleFacts(ast.NodeVisitor):
    """Prepass: compiled names, torch-math local functions, module
    instances, pinned host buffers, and names that are handed to a
    compiler, a graph capture or a capturing executor (and therefore *are*
    captured even though their def site looks plain)."""

    def __init__(self, aliases: dict[str, str]) -> None:
        self.aliases = aliases
        self.jitted_names: set[str] = set()       # plain names = torch.compile(...)
        self.jitted_attrs: set[str] = set()       # self.<attr> = torch.compile(...)
        self.module_names: set[str] = set()       # plain names = torch.nn.<Module>(...)
        self.module_attrs: set[str] = set()
        self.pinned: set[str] = set()             # buffer keys of pinned host memory
        self.device_fn_defs: set[str] = set()     # local defs doing torch math
        self.jit_wrapped_args: set[str] = set()   # names compiled or captured
        # interprocedural helper summaries (one hop, same module)
        self.helper_sync_params: dict[str, set[int]] = {}  # def -> param idxs
        self.helper_calls_jit: set[str] = set()   # defs capturing/compiling inside
        self.device_fn_via: dict[str, str] = {}   # wrapper -> device-math callee
        self.host_level_defs: set[str] = set()    # fence/clock orchestration
        self.device_methods: set[str] = set()     # methods launching device work
        self._callees: dict[str, set[str]] = {}   # def -> plain-Name callees
        self._methods: list = []                  # defs directly in a class body
        self._replays: set[str] = set()           # defs replaying a CUDA graph

    def _module_ctor(self, call: ast.Call) -> bool:
        d = _dotted(call.func, self.aliases)
        return (d is not None and d.startswith("torch.nn.")
                and not d.startswith("torch.nn.functional.")
                and d.rsplit(".", 1)[1][:1].isupper())

    def visit_Assign(self, node: ast.Assign) -> None:
        if isinstance(node.value, ast.Call):
            d = _dotted(node.value.func, self.aliases)
            compiled = d in _COMPILE_WRAPPERS
            module = self._module_ctor(node.value)
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if compiled:
                        self.jitted_names.add(t.id)
                    if module:
                        self.module_names.add(t.id)
                elif isinstance(t, ast.Attribute):
                    if compiled:
                        self.jitted_attrs.add(t.attr)
                    if module:
                        self.module_attrs.add(t.attr)
        if _pins(node.value):
            for t in node.targets:
                key = _buf_key(t)
                if key is not None:
                    self.pinned.add(key)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        d = _dotted(node.func, self.aliases)
        if d in _COMPILE_WRAPPERS:
            for a in node.args:
                if isinstance(a, ast.Name):
                    self.jit_wrapped_args.add(a.id)
        if d is not None and d.rsplit(".", 1)[-1] == _CAPTURING_EXECUTOR:
            step = node.args[0] if node.args else _kw(node, "step_fn")
            if isinstance(step, ast.Name):
                self.jit_wrapped_args.add(step.id)
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        # every plain-name call inside ``with torch.cuda.graph(...)`` is
        # captured into the graph
        if any(isinstance(it.context_expr, ast.Call)
               and _dotted(it.context_expr.func, self.aliases) in _CAPTURE_CTX
               for it in node.items):
            for s in node.body:
                for sub in ast.walk(s):
                    if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name):
                        self.jit_wrapped_args.add(sub.func.id)
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._methods.extend(sub for sub in node.body
                             if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)))
        self.generic_visit(node)

    def _visit_def(self, node) -> None:
        for dec in node.decorator_list:
            d = _dotted(dec.func if isinstance(dec, ast.Call) else dec,
                        self.aliases)
            if d in _COMPILE_WRAPPERS:
                self.jitted_names.add(node.name)
            if isinstance(dec, ast.Call) and d and d.endswith("partial"):
                if any(_dotted(a, self.aliases) in _COMPILE_WRAPPERS
                       for a in dec.args):
                    self.jitted_names.add(node.name)
        does_device_math = False
        host_level = False
        params = [a.arg for a in node.args.args]
        param_idx = {p: i for i, p in enumerate(params)}
        sync_params: set[int] = set()
        callees: set[str] = set()
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            d = _dotted(sub.func, self.aliases)
            if _is_torch_math(d):
                does_device_math = True
            elif _is_fence(sub, self.aliases) or d in _CLOCK_CALLS:
                # a function that fences, reads back or takes wall-clock
                # timestamps is host-level orchestration: it cannot be
                # captured in a graph wholesale, so TV005 does not apply
                host_level = True
            if d in _CAPTURE_CALLS:
                self.helper_calls_jit.add(node.name)
            # helper summary: which parameters this def host-syncs
            if (d in _SYNC_CALLS or _ends_with(d, _READBACK_SUFFIXES)) and sub.args \
                    and isinstance(sub.args[0], ast.Name) \
                    and sub.args[0].id in param_idx:
                sync_params.add(param_idx[sub.args[0].id])
            if isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in _SYNC_METHODS \
                    and isinstance(sub.func.value, ast.Name) \
                    and sub.func.value.id in param_idx:
                sync_params.add(param_idx[sub.func.value.id])
            if isinstance(sub.func, ast.Name):
                callees.add(sub.func.id)
            if isinstance(sub.func, ast.Attribute) and sub.func.attr == "replay":
                self._replays.add(node.name)
        if does_device_math and not host_level:
            self.device_fn_defs.add(node.name)
        if host_level:
            self.host_level_defs.add(node.name)
        if sync_params:
            self.helper_sync_params[node.name] = sync_params
        self._callees[node.name] = callees
        self.generic_visit(node)

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def finalize(self) -> None:
        """Resolve one-hop transitivity after the whole module is seen
        (helpers may be defined before their callees): a plain wrapper
        whose body calls a local device-math def *reaches* device math,
        unless the callee is captured (compiled, or handed to a compiler,
        a graph capture or a capturing executor) — calling a captured
        function per tick is exactly right.  A method that does device math
        or replays a CUDA graph, and neither fences nor reads a clock,
        launches device work when called through ``self``."""
        for m in self._methods:
            if m.name not in self.host_level_defs and (
                    m.name in self.device_fn_defs or m.name in self._replays):
                self.device_methods.add(m.name)
        for name, callees in self._callees.items():
            if name in self.device_fn_defs or name in self.host_level_defs:
                continue
            for c in sorted(callees):
                if (c != name and c in self.device_fn_defs
                        and c not in self.jitted_names
                        and c not in self.jit_wrapped_args):
                    self.device_fn_via[name] = c
                    break


class _Analyzer(ast.NodeVisitor):
    """Main pass: emits findings with formatting-stable keys."""

    def __init__(self, path: str, facts: _ModuleFacts) -> None:
        self.path = path
        self.facts = facts
        self.aliases = facts.aliases
        self.findings: list[Finding] = []
        self._scope: list[str] = []
        self._loop_depth = 0
        self._jit_ctx = 0
        self._loop_vars: set[str] = set()
        self._device_vars: list[set[str]] = [set()]
        self._stmt_stack: list[ast.stmt] = []
        self._fn_stack: list[str] = []
        self._key_counts: dict[str, int] = {}

    # ------------------------------------------------ bookkeeping -----
    @property
    def scope(self) -> str:
        return ".".join(self._scope) if self._scope else "<module>"

    def _hot(self) -> bool:
        if self._loop_depth:
            return True
        return any(HOT_FUNCTION_RE.search(s) for s in self._scope)

    def _emit(self, rule: str, node: ast.AST, message: str,
              stmt: Optional[ast.stmt] = None) -> None:
        if stmt is None:
            stmt = self._stmt_stack[-1] if self._stmt_stack else node
        base = (f"{self.path}::{self.scope}::{rule}::{_fingerprint(stmt)}")
        n = self._key_counts.get(base, 0)
        self._key_counts[base] = n + 1
        key = base if n == 0 else f"{base}#{n}"
        r = RULES[rule]
        self.findings.append(Finding(
            rule=rule, axis=r.axis, path=self.path,
            line=getattr(node, "lineno", 0), col=getattr(node, "col_offset", 0),
            scope=self.scope, message=message, hint=r.hint, key=key))

    # ------------------------------------------------ device tracking -
    def _is_device_expr(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self._device_vars[-1]
        if isinstance(node, ast.Attribute):
            # x.shape / x.ndim / x.dtype / x.device are static Python
            # metadata of a device tensor — branching on them is
            # shape-polymorphic dispatch, not a host sync
            if node.attr in _STATIC_ATTRS:
                return False
            return self._is_device_expr(node.value)
        if isinstance(node, (ast.Subscript, ast.Starred)):
            return self._is_device_expr(node.value)
        if isinstance(node, ast.BinOp):
            return (self._is_device_expr(node.left)
                    or self._is_device_expr(node.right))
        if isinstance(node, ast.UnaryOp):
            return self._is_device_expr(node.operand)
        if isinstance(node, ast.Compare):
            # identity tests (``x is None``) and key tests (``"k" in tree``)
            # read the Python objects, never a device value
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            if all(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops) \
                    and isinstance(node.left, ast.Constant) \
                    and isinstance(node.left.value, str):
                return False
            return (self._is_device_expr(node.left)
                    or any(self._is_device_expr(c) for c in node.comparators))
        if isinstance(node, ast.Call):
            return self._is_device_call(node)
        return False

    def _is_device_call(self, call: ast.Call) -> bool:
        d = _dotted(call.func, self.aliases)
        if d:
            if _is_torch_math(d):
                return True
            root = d.split(".")[0]
            if root in self.facts.jitted_names or d in self.facts.jitted_names:
                return True
        if isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            if attr in self.facts.jitted_attrs or attr in self.facts.module_attrs:
                return True
            if attr in _DEVICE_ATTR_CALLS or attr == "cuda":
                return True
            if attr in self.facts.device_methods and isinstance(call.func.value, ast.Name) \
                    and call.func.value.id == "self":
                return True
            if attr == "to" and not _to_cpu(call):
                return True
            # a tensor method of a device value stays on the device
            if attr not in _HOST_METHODS and self._is_device_expr(call.func.value):
                return True
        if isinstance(call.func, ast.Name):
            if call.func.id in self.facts.jitted_names \
                    or call.func.id in self.facts.module_names:
                return True
        return False

    def _mark_targets(self, target: ast.AST, device: bool) -> None:
        if isinstance(target, ast.Name):
            if device:
                self._device_vars[-1].add(target.id)
            else:
                self._device_vars[-1].discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._mark_targets(e, device)
        elif isinstance(target, ast.Starred):
            self._mark_targets(target.value, device)

    # ------------------------------------------------ scope plumbing --
    def _enter_function(self, node) -> None:
        self._scope.append(node.name)
        devs: set[str] = set()
        for arg in list(node.args.args) + list(node.args.kwonlyargs):
            ann = getattr(arg, "annotation", None)
            if ann is not None:
                d = _dotted(ann, self.aliases)
                if d in _DEVICE_ANNOTATIONS:
                    devs.add(arg.arg)
        self._device_vars.append(devs)
        self._fn_stack.append(node.name)
        self._check_tv007(node)
        jitted_def = node.name in self.facts.jitted_names
        if jitted_def:
            self._jit_ctx += 1
        outer_loops, self._loop_depth = self._loop_depth, 0
        self._scan_tv006(node)
        self._scan_tv004(node)
        self.generic_visit(node)
        self._loop_depth = outer_loops
        if jitted_def:
            self._jit_ctx -= 1
        self._fn_stack.pop()
        self._device_vars.pop()
        self._scope.pop()

    visit_FunctionDef = _enter_function
    visit_AsyncFunctionDef = _enter_function

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    def generic_visit(self, node: ast.AST) -> None:
        is_stmt = isinstance(node, ast.stmt)
        if is_stmt:
            self._stmt_stack.append(node)
        super().generic_visit(node)
        if is_stmt:
            self._stmt_stack.pop()

    def visit_With(self, node: ast.With) -> None:
        # the body of ``with torch.cuda.graph(...)`` is captured: device
        # math and plain calls inside it become the graph
        captured = any(isinstance(it.context_expr, ast.Call)
                       and _dotted(it.context_expr.func, self.aliases) in _CAPTURE_CTX
                       for it in node.items)
        if captured:
            self._jit_ctx += 1
        self.generic_visit(node)
        if captured:
            self._jit_ctx -= 1

    # ------------------------------------------------ TV007 -----------
    def _check_tv007(self, fn) -> None:
        """Mutable (or constructed) parameter defaults: evaluated once at
        def time and aliased by every call."""
        defaults = list(fn.args.defaults) + [
            d for d in fn.args.kw_defaults if d is not None]
        for d in defaults:
            self._stmt_stack.append(fn)   # fingerprint the whole def
            try:
                if isinstance(d, _MUTABLE_DISPLAYS):
                    kind = type(d).__name__.replace("Comp", " comprehension") \
                        .lower()
                    self._emit(
                        "TV007", d,
                        f"mutable default ({kind} display) is evaluated "
                        "once at def time and shared by every call — use "
                        "a None sentinel")
                elif isinstance(d, ast.Call):
                    name = _dotted(d.func, self.aliases) or "<call>"
                    if name in _IMMUTABLE_DEFAULT_CALLS:
                        continue
                    self._emit(
                        "TV007", d,
                        f"default {name}() is constructed once at def time "
                        "and shared by every call — use a None sentinel and "
                        "construct per call")
            finally:
                self._stmt_stack.pop()

    # ------------------------------------------------ loops -----------
    def _enter_loop(self, node) -> None:
        if isinstance(node, ast.For):
            names: set[str] = set()
            self._collect_names(node.target, names)
            added = names - self._loop_vars
            self._loop_vars |= added
        else:
            added = set()
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1
        self._loop_vars -= added

    @staticmethod
    def _collect_names(node: ast.AST, out: set[str]) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name):
                out.add(sub.id)

    def visit_For(self, node: ast.For) -> None:
        self._enter_loop(node)

    def visit_While(self, node: ast.While) -> None:
        if self._is_device_expr(node.test):
            self._emit("TV002", node.test,
                       "Python while-condition on a device value forces a "
                       "blocking host sync every iteration")
        if self._hot() and self._is_unbounded_retry(node):
            self._emit("TV008", node,
                       "unbounded `while True` retry: the exception handler "
                       "never raises, breaks, or returns, so a persistent "
                       "fault spins this hot path forever")
        self._enter_loop(node)

    # ------------------------------------------------ fault swallowing
    @staticmethod
    def _swallows(handler: ast.ExceptHandler) -> bool:
        """True when nothing in the handler can leave the loop/function:
        no raise, no break, no return anywhere in its body."""
        return not any(isinstance(n, (ast.Raise, ast.Break, ast.Return))
                       for n in ast.walk(handler))

    @staticmethod
    def _is_broad(handler: ast.ExceptHandler) -> bool:
        if handler.type is None:
            return True
        names = ([handler.type] if not isinstance(handler.type, ast.Tuple)
                 else handler.type.elts)
        return any(isinstance(t, ast.Name)
                   and t.id in ("Exception", "BaseException")
                   for t in names)

    @classmethod
    def _is_unbounded_retry(cls, node: ast.While) -> bool:
        """``while True`` (constant-truthy test) containing a ``try``
        whose every handler swallows: only a clean iteration can ever
        exit, so a persistent fault loops forever.  Any non-swallowing
        handler (it re-raises or breaks out) bounds the loop."""
        if not (isinstance(node.test, ast.Constant) and node.test.value):
            return False
        for sub in ast.walk(node):
            if isinstance(sub, ast.Try) and sub.handlers and all(
                    cls._swallows(h) for h in sub.handlers):
                return True
        return False

    def visit_Try(self, node: ast.Try) -> None:
        if self._hot():
            for handler in node.handlers:
                # swallow-only means literally inert: every statement is
                # a pass/continue.  A handler that logs, counts, backs
                # off, or falls back at least made the fault observable.
                inert = all(isinstance(s, (ast.Pass, ast.Continue))
                            for s in handler.body)
                if inert and self._is_broad(handler):
                    what = ("bare `except:`" if handler.type is None
                            else "broad `except` clause")
                    self._emit(
                        "TV008", handler,
                        f"{what} that only "
                        f"{'passes' if isinstance(handler.body[0], ast.Pass) else 'continues'} "
                        f"in a hot path: the fault (and its latency cost) "
                        f"vanishes silently")
        self.generic_visit(node)

    def _enter_comp(self, node) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_ListComp = _enter_comp
    visit_SetComp = _enter_comp
    visit_DictComp = _enter_comp
    visit_GeneratorExp = _enter_comp

    # ------------------------------------------------ branches --------
    def visit_If(self, node: ast.If) -> None:
        if self._is_device_expr(node.test):
            self._emit("TV002", node.test,
                       "Python branch on a device value: a host sync per "
                       "evaluation, and a capture error inside a CUDA graph "
                       "— use torch.where")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        if self._is_device_expr(node.test):
            self._emit("TV002", node.test,
                       "ternary on a device value — use torch.where")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        if self._is_device_expr(node.test):
            self._emit("TV002", node.test,
                       "assert on a device value forces a host sync")
        self.generic_visit(node)

    # ------------------------------------------------ assignments -----
    def visit_Assign(self, node: ast.Assign) -> None:
        device = self._is_device_expr(node.value)
        self.generic_visit(node)
        for t in node.targets:
            self._mark_targets(t, device)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.generic_visit(node)
        if self._is_device_expr(node.value):
            self._mark_targets(node.target, True)

    # ------------------------------------------------ calls -----------
    def visit_Call(self, node: ast.Call) -> None:
        d = _dotted(node.func, self.aliases)
        if _ends_with(d, _FENCE_SUFFIXES):
            # whatever a caller fences is a device value from here on
            for a in node.args:
                self._mark_targets(a, True)
        self._check_tv001(node, d)
        self._check_tv002_capture(node, d)
        self._check_tv003(node, d)
        self._check_tv005(node, d)
        if d in _COMPILE_WRAPPERS:
            # arguments of a compiler compile into its program: device
            # math and "uncaptured" calls inside are exactly right
            self._jit_ctx += 1
            self.generic_visit(node)
            self._jit_ctx -= 1
        else:
            self.generic_visit(node)

    def _check_tv001(self, node: ast.Call, d: Optional[str]) -> None:
        if self._jit_ctx or not self._loop_depth:
            return
        if _ends_with(d, _READBACK_SUFFIXES):
            self._emit("TV001", node,
                       "core.timing.to_host inside a loop: one readback per "
                       "iteration instead of one per tick")
            return
        if d in _SYNC_CALLS and node.args \
                and self._is_device_expr(node.args[0]):
            self._emit("TV001", node,
                       f"{d.replace('numpy', 'np')}() on a device value "
                       "inside a loop blocks on the device per iteration")
            return
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SYNC_METHODS \
                and self._is_device_expr(node.func.value):
            self._emit("TV001", node,
                       f".{node.func.attr}() on a device value inside a "
                       "loop blocks on the device per iteration")
            return
        # interprocedural: a local helper that host-syncs one of its
        # parameters, handed a device value at that position
        if isinstance(node.func, ast.Name) \
                and node.func.id not in self.facts.jitted_names:
            sync_params = self.facts.helper_sync_params.get(node.func.id)
            if sync_params:
                for i, a in enumerate(node.args):
                    if i in sync_params and self._is_device_expr(a):
                        self._emit(
                            "TV001", node,
                            f"device value blocks on the device per "
                            f"iteration via {node.func.id}(): its body "
                            f"host-syncs parameter {i}")
                        break

    def _check_tv002_capture(self, node: ast.Call, d: Optional[str]) -> None:
        per_tick = self._loop_depth or (self._hot() and self._scope)
        if d not in _CAPTURE_CALLS:
            # interprocedural: invoking a local helper that captures or
            # compiles in its body builds a fresh program per call
            if isinstance(node.func, ast.Name) \
                    and node.func.id in self.facts.helper_calls_jit \
                    and not self._jit_ctx and per_tick:
                self._emit(
                    "TV002", node,
                    f"per-tick capture via {node.func.id}(): its body "
                    "captures a CUDA graph or compiles, so every invocation "
                    "builds afresh")
            return
        if per_tick:
            self._emit("TV002", node,
                       f"{d} called in a per-tick context: every call "
                       "captures or compiles a fresh program")
        if d not in _COMPILE_WRAPPERS:
            return
        for a in node.args:
            if isinstance(a, ast.Lambda):
                free: set[str] = set()
                self._collect_names(a.body, free)
                bound = {x.arg for x in a.args.args}
                leaked = (free - bound) & self._loop_vars
                if leaked:
                    self._emit(
                        "TV002", a,
                        "compile of a lambda closing over loop variable(s) "
                        f"{sorted(leaked)}: the closure changes every "
                        "iteration, defeating the compile cache")

    def _check_tv003(self, node: ast.Call, d: Optional[str]) -> None:
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _TORCH_INPLACE_DRAWS \
                and _kw(node, "generator") is None:
            self._emit("TV003", node,
                       f"in-place .{node.func.attr}() with no generator= "
                       "draws from torch's global generator: process-wide, "
                       "replay-hostile")
            return
        if isinstance(node.func, ast.Attribute) and node.func.attr == "manual_seed" \
                and d not in _SEEDED_SINKS:
            self._check_clock_seed(node)
            return
        if d is None:
            return
        if d.startswith("numpy.random."):
            leaf = d.rsplit(".", 1)[1]
            if leaf in _GLOBAL_NP_RANDOM:
                self._emit("TV003", node,
                           f"global-state np.random.{leaf}: unseeded, "
                           "process-wide, replay-hostile — use "
                           "np.random.default_rng(seed)")
                return
            if leaf == "default_rng" and not node.args and not node.keywords:
                self._emit("TV003", node,
                           "np.random.default_rng() with no seed draws OS "
                           "entropy: two runs diverge")
                return
        if d.startswith("random.") and d.rsplit(".", 1)[1] in _STDLIB_RANDOM:
            self._emit("TV003", node,
                       f"stdlib {d}: global-state RNG — use a seeded "
                       "np.random.default_rng")
            return
        if d.startswith("torch.") and d.count(".") == 1:
            leaf = d[len("torch."):]
            if leaf in _TORCH_GLOBAL_DRAWS and _kw(node, "generator") is None:
                self._emit("TV003", node,
                           f"torch.{leaf} with no generator= draws from "
                           "torch's global generator: process-wide, "
                           "replay-hostile — pass a seeded torch.Generator")
                return
            if leaf == "seed":
                self._emit("TV003", node,
                           "torch.seed() seeds the global generator from OS "
                           "entropy: two runs diverge")
                return
        if d in _SEEDED_SINKS:
            self._check_clock_seed(node)

    def _check_clock_seed(self, node: ast.Call) -> None:
        for a in list(node.args) + [k.value for k in node.keywords]:
            for sub in ast.walk(a):
                if isinstance(sub, ast.Call) \
                        and _dotted(sub.func, self.aliases) \
                        in _CLOCK_CALLS:
                    self._emit("TV003", sub,
                               "wall-clock time feeding a seed/key: "
                               "every run randomizes differently")
                    break

    def _check_tv005(self, node: ast.Call, d: Optional[str]) -> None:
        if self._jit_ctx or not self._hot():
            return
        if not isinstance(node.func, ast.Name):
            return
        name = node.func.id
        via: Optional[str] = None
        if name not in self.facts.device_fn_defs:
            # interprocedural: a plain wrapper reaching device math one
            # plain-name hop down
            via = self.facts.device_fn_via.get(name)
            if via is None:
                return
        if name in self.facts.jitted_names \
                or name in self.facts.jit_wrapped_args:
            return
        # definitional code: a device-math helper called from inside
        # another device-math function runs inside the caller's capture
        if self._fn_stack and self._fn_stack[-1] in self.facts.device_fn_defs:
            return
        # factory pattern: the result is captured elsewhere
        # (step_fn = make_step(...); torch.compile(step_fn))
        stmt = self._stmt_stack[-1] if self._stmt_stack else None
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name) \
                        and t.id in self.facts.jit_wrapped_args:
                    return
        if via is not None:
            self._emit("TV005", node,
                       f"{name}() reaches device math via {via}() but is "
                       "never captured: per-tick calls launch op by op")
        else:
            self._emit("TV005", node,
                       f"{name}() performs device math but is never "
                       "captured: per-tick calls launch op by op")

    # ------------------------------------------------ TV004 -----------
    def _scan_tv004(self, fn) -> None:
        """Async hand-off: walk the body in source order (branches merged,
        each loop body twice so a copy of one iteration meets the writes
        of the next), tracking the host buffers that a ``non_blocking``
        copy may still be reading (sources) or writing (destinations)
        until the next fence."""
        hot_fn = any(HOT_FUNCTION_RE.search(s) for s in self._scope)
        pinned = set(self.facts.pinned)
        seen: set[tuple[int, str]] = set()

        def emit(node: ast.AST, stmt: ast.stmt, message: str, what: str) -> None:
            if (id(node), what) in seen:
                return
            seen.add((id(node), what))
            self._emit("TV004", node, message, stmt=stmt)

        def headers(s: ast.stmt) -> list[ast.AST]:
            if isinstance(s, (ast.For, ast.AsyncFor)):
                return [s.iter]
            if isinstance(s, (ast.While, ast.If)):
                return [s.test]
            if isinstance(s, (ast.With, ast.AsyncWith)):
                return [it.context_expr for it in s.items]
            if isinstance(s, (ast.Try, *_SCOPES)):
                return []
            return [s]

        def step(s: ast.stmt, exprs: list[ast.AST], hot: bool, state: dict) -> None:
            src, dst = state["src"], state["dst"]
            calls = [n for e in exprs for n in _walk_local(e) if isinstance(n, ast.Call)]
            # 1. hazards against the copies still in flight
            copy_receivers = {id(c.func.value) for c in calls
                              if isinstance(c.func, ast.Attribute) and c.func.attr == "copy_"}
            for c in calls:
                target = None
                if isinstance(c.func, ast.Attribute) and c.func.attr.endswith("_") \
                        and not c.func.attr.startswith("_") \
                        and c.func.attr not in _TORCH_INPLACE_DRAWS:
                    target = c.func.value
                elif _dotted(c.func, self.aliases) == "numpy.copyto" and c.args:
                    target = c.args[0]
                key = _buf_key(target) if target is not None else None
                if hot and key in src:
                    emit(c, s, f"host buffer '{key}' is written again while the "
                               "non_blocking copy from it may still be reading "
                               "it: no event or stream fence in between", "src")
            if isinstance(s, (ast.Assign, ast.AugAssign)):
                targets = s.targets if isinstance(s, ast.Assign) else [s.target]
                for t in targets:
                    if isinstance(t, ast.Subscript) or isinstance(s, ast.AugAssign):
                        key = _buf_key(t)
                        if hot and key in src:
                            emit(t, s, f"host buffer '{key}' is written again while "
                                       "the non_blocking copy from it may still be "
                                       "reading it: no event or stream fence in "
                                       "between", "src")
            for e in exprs:
                for n in _walk_local(e):
                    if isinstance(n, (ast.Name, ast.Attribute)) \
                            and isinstance(n.ctx, ast.Load) and id(n) not in copy_receivers:
                        key = _buf_key(n)
                        if key in dst:
                            emit(n, s, f"'{key}' is read before the non_blocking "
                                       "device-to-host copy into it is fenced: it may "
                                       "not hold the data yet", "dst")
            # 2. fences retire every copy in flight
            if any(_is_fence(c, self.aliases) for c in calls):
                src.clear()
                dst.clear()
            # 3. this statement's own non_blocking copies
            for c in calls:
                if not (isinstance(c.func, ast.Attribute) and _non_blocking(c)):
                    continue
                if c.func.attr == "copy_" and c.args:
                    out = _buf_key(c.func.value)
                    if out in pinned:
                        dst[out] = c
                    else:
                        key = _buf_key(c.args[0])
                        if key is not None:
                            src[key] = c
                elif c.func.attr in ("to", "cuda", "cpu"):
                    if _to_cpu(c):
                        if isinstance(s, ast.Assign) and s.value is c:
                            for t in s.targets:
                                key = _buf_key(t)
                                if key is not None:
                                    dst[key] = c
                    else:
                        key = _buf_key(c.func.value)
                        if key is not None:
                            src[key] = c
            if isinstance(s, ast.Assign) and _pins(s.value):
                for t in s.targets:
                    key = _buf_key(t)
                    if key is not None:
                        pinned.add(key)

        def merge(a: dict, b: dict) -> dict:
            return {"src": {**a["src"], **b["src"]}, "dst": {**a["dst"], **b["dst"]}}

        def copy(state: dict) -> dict:
            return {"src": dict(state["src"]), "dst": dict(state["dst"])}

        def run(body: list, depth: int, state: dict) -> dict:
            for s in body:
                if isinstance(s, _SCOPES):
                    continue
                hot = hot_fn or depth > 0
                step(s, headers(s), hot, state)
                if isinstance(s, (ast.For, ast.AsyncFor, ast.While)):
                    for _ in range(2):
                        state = merge(state, run(s.body, depth + 1, copy(state)))
                    state = run(s.orelse, depth, state)
                elif isinstance(s, ast.If):
                    state = merge(run(s.body, depth, copy(state)),
                                  run(s.orelse, depth, copy(state)))
                elif isinstance(s, (ast.With, ast.AsyncWith)):
                    state = run(s.body, depth, state)
                elif isinstance(s, ast.Try):
                    state = run(s.body, depth, state)
                    for h in s.handlers:
                        state = merge(state, run(h.body, depth, copy(state)))
                    state = run(s.orelse, depth, state)
                    state = run(s.finalbody, depth, state)
            return state

        run(fn.body, 0, {"src": {}, "dst": {}})

    # ------------------------------------------------ TV006 -----------
    @staticmethod
    def _with_fences(s: ast.stmt) -> bool:
        """True for a ``with ...span(..., fence=...)`` statement — the obs
        tracer's fenced timing site: the context manager synchronises the
        fenced tensors' devices before closing the span, so exiting the
        block fences any open wall-clock interval."""
        for item in getattr(s, "items", []) or []:
            call = item.context_expr
            if isinstance(call, ast.Call) \
                    and isinstance(call.func, ast.Attribute) \
                    and call.func.attr == "span":
                for kw in call.keywords:
                    if kw.arg == "fence":
                        if isinstance(kw.value, ast.Constant) \
                                and not kw.value.value:
                            break          # explicit fence=False/None
                        return True
        return False

    def _scan_tv006(self, fn) -> None:
        """Linear scan of a function body in source order: a clock anchor
        ``t = time.perf_counter()`` closed by ``... - t`` after a device
        call with no fence in between measures the launch, not the work.
        The key fingerprints the statement that closes the interval."""
        stmts: list[ast.stmt] = []

        def flatten(body) -> None:
            for s in body:
                stmts.append(s)
                if self._with_fences(s):
                    # the fenced-span block is one atomic timing site:
                    # its body is covered by walking the With node itself,
                    # and the exit fence lands after everything inside
                    continue
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(s, field, None)
                    if sub and not isinstance(
                            s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                        flatten(sub)
                for h in getattr(s, "handlers", []) or []:
                    flatten(h.body)

        flatten(fn.body)
        anchors: dict[str, dict] = {}
        for s in stmts:
            closes: list[tuple[str, ast.BinOp]] = []
            for sub in ast.walk(s):
                if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Sub) \
                        and isinstance(sub.right, ast.Name) \
                        and sub.right.id in anchors:
                    left_ok = (
                        isinstance(sub.left, ast.Call)
                        and _dotted(sub.left.func, self.aliases)
                        in _CLOCK_CALLS
                    ) or (isinstance(sub.left, ast.Name)
                          and sub.left.id in anchors)
                    if left_ok:
                        closes.append((sub.right.id, sub))
            for name, binop in closes:
                st = anchors.pop(name, None)
                if st is None:
                    continue
                if st["jitted"] and not st["fenced"]:
                    self._emit("TV006", binop,
                               f"interval '{name}' closes after a device "
                               "call with no synchronize/event fence: this "
                               "measures the launch, not the work", stmt=s)
            for sub in ast.walk(s):
                if not isinstance(sub, ast.Call):
                    continue
                if _is_fence(sub, self.aliases):
                    for st in anchors.values():
                        st["fenced"] = True
                elif self._is_device_call(sub):
                    for st in anchors.values():
                        st["jitted"] = True
                        st["fenced"] = False
            if self._with_fences(s):
                # block exit runs after every call inside: the span's
                # fence synchronises whatever the body launched
                for st in anchors.values():
                    st["fenced"] = True
            if isinstance(s, ast.Assign) and isinstance(s.value, ast.Call) \
                    and _dotted(s.value.func, self.aliases) in _CLOCK_CALLS:
                for t in s.targets:
                    if isinstance(t, ast.Name):
                        anchors[t.id] = {"jitted": False, "fenced": False}


def analyze_module(source: str, path: str) -> list[Finding]:
    """Run every rule over one module's source.  ``path`` is the
    root-relative posix path used in finding keys."""
    tree = ast.parse(source, filename=path)
    facts = _ModuleFacts(_collect_aliases(tree))
    facts.visit(tree)
    facts.finalize()
    analyzer = _Analyzer(path, facts)
    analyzer.visit(tree)
    analyzer.findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return analyzer.findings
