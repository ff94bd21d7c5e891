"""Static FLOP/byte counting of a torch program, op by op, on fake tensors.

The certifier's cost model is *static*: ``count_program`` runs a program
under ``FakeTensorMode`` (shapes, dtypes and strides, no storage and no
arithmetic) beneath a ``TorchDispatchMode`` that sees every aten op the
program issues, and accumulates per-op work and data movement from the
ops' tensor shapes alone.  Everything is exact arithmetic over static
shapes, so two counts of the same program agree bit for bit, which
``--check`` depends on.  Python loops unroll into the op stream by
themselves; autograd's backward ops are counted where a program calls
``autograd.grad``.

Counting conventions (the reference's, ``repro/analysis/cert/costs.py``;
all keep the roofline latency a floor):

* ``mm``/``bmm``/``addmm``/``baddbmm`` (and ``mv``, ``dot``) —
  ``2 · prod(out) · K`` (one multiply and one add per MAC).
* ``convolution`` — ``2 · prod(out) · C_in/groups · prod(kernel)``, read
  off the weight, which is per group; ``convolution_backward`` the same
  once per gradient it computes.
* pointwise ops (``torch.Tag.pointwise``) — one flop per output element;
  transcendental ones are also tallied in ``transcendentals``.
* reductions, cumulative ops and sorts — one flop per *input* element.
* views, copies and layout ops — zero flops, input plus output bytes into
  ``mem_bytes``.
* scatter-adds — the update's elements as flops, bytes into ``mem_bytes``.
* a kernel entry point of ``kernels.ops`` — its declared cost
  (``kernels/cost.py``), through ``ops.count_hook``: never the arithmetic
  of its plain version.  Under grad the kernel's backward is counted as
  the port runs it: the flash backward kernel by its declared cost, the
  scans' backward as the chunked form recomputed under autograd (aten
  ops).
* host-interaction ops (``aten._local_scalar_dense``, ``nonzero``,
  ``masked_select``, a copy across devices, and any op that raises
  ``DynamicOutputShapeException`` or ``DataDependentOutputException``) —
  no cost, recorded in ``host_prims`` with the source line that issued
  them; the exception is recorded, and the count goes on with a stand-in
  of the op's largest output.

Unknown ops count zero flops and are listed in ``unknown``, so a new
torch widening the op set degrades visibly, never silently.

Besides the reference's fields, ``io_bytes`` is every op's input plus
output bytes (views excluded: they move nothing), the unfused traffic,
and ``write_bytes`` the output bytes of every op that computes (neither a
view nor a copy nor a creation), from which ``launch.roofline`` forms
its fused estimate.  ``saved_bytes`` is the most that tensors saved for
backward held at once (the program's inputs apart; a saved tensor counts
until it is freed): an activation estimate, not an allocator's peak.  And
``mutated`` the program inputs that an op wrote in place (by the op
schema's alias information): the torch counterpart of ``donated_invars``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import traceback
import weakref
from typing import Any, Callable

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.kernels import cost as kcost
from repro_torch.kernels import ops as kops

__all__ = ["Counts", "count_program", "program_io_bytes", "counting"]

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot"}
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "sqrt", "rsqrt", "pow",
    "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh", "asinh",
    "acosh", "atanh", "erf", "erfc", "erfinv", "sigmoid", "logit", "digamma", "lgamma",
    "gelu", "silu", "softplus", "mish", "xlogy", "logaddexp",
}
# one flop per input element (reductions without the tag, sorts, scans)
_REDUCE = {
    "sum", "mean", "prod", "amax", "amin", "argmax", "argmin", "max", "min", "cumsum",
    "cumprod", "cummax", "cummin", "logcumsumexp", "var", "std", "var_mean", "std_mean",
    "norm", "linalg_vector_norm", "logsumexp", "any", "all", "sort", "topk", "kthvalue",
    "median", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "avg_pool2d", "max_pool2d_with_indices",
    "avg_pool2d_backward", "nll_loss_forward", "nll_loss_backward", "nll_loss2d_forward",
    "count_nonzero", "aminmax",
}
_MOVEMENT = {
    "clone", "copy", "copy_", "_to_copy", "contiguous", "cat", "stack", "flip", "roll",
    "repeat", "index_select", "gather", "index", "_unsafe_index", "index_put",
    "_index_put_impl", "constant_pad_nd", "empty", "empty_like", "empty_strided", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "fill", "fill_", "zero_",
    "zero", "new_empty", "new_empty_strided", "new_zeros", "new_ones", "new_full", "arange",
    "lift_fresh", "lift_fresh_copy", "detach", "slice_scatter", "select_scatter",
    "diagonal_scatter", "as_strided_scatter", "embedding", "index_copy", "index_copy_",
    "scatter", "scatter_", "tril", "triu", "_unsafe_view", "masked_scatter", "tril_indices",
    "triu_indices", "eye", "linspace", "scalar_tensor", "rand", "randn", "randint",
    "bernoulli", "bernoulli_", "normal", "uniform_", "normal_", "resize_", "set_",
    "unfold_copy", "view_copy", "permute_copy", "split_with_sizes_copy", "t_copy",
    "expand_copy", "transpose_copy", "unsqueeze_copy", "squeeze_copy", "select_copy",
    "slice_copy", "alias_copy", "repeat_interleave", "narrow_copy", "pixel_shuffle",
    "_reshape_alias", "reflection_pad2d", "replication_pad2d", "upsample_nearest2d",
    "select_backward", "slice_backward", "index_select_backward", "expand_backward",
    "unfold_backward", "diagonal_backward", "as_strided_backward", "permute_backward",
}
_SCATTER_ADD = {"index_add", "index_add_", "scatter_add", "scatter_add_", "scatter_reduce",
                "scatter_reduce_", "embedding_dense_backward", "_index_put_impl_",
                "index_put_"}
_HOST = {"_local_scalar_dense", "nonzero", "masked_select", "item", "is_nonzero", "equal",
         "nonzero_static", "unique", "_unique2", "unique_consecutive", "unique_dim"}
# bookkeeping: no cost, no bytes
_FREE = {"device", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
         "_has_compatible_shallow_copy_type", "_assert_async", "_assert_scalar",
         "_functional_assert_async", "record_stream", "_nested_tensor_from_mask_left_aligned",
         "_to_dense", "_record_function_enter", "_record_function_enter_new",
         "_record_function_exit"}


@dataclasses.dataclass
class Counts:
    """Accumulated static cost of one program."""

    flops: float = 0.0
    mem_bytes: float = 0.0            # movement-op traffic
    transcendentals: float = 0.0
    by_prim: dict = dataclasses.field(default_factory=dict)
    host_prims: list = dataclasses.field(default_factory=list)   # [source, op]
    while_loops: int = 0
    unknown: list = dataclasses.field(default_factory=list)
    io_bytes: float = 0.0             # every op's inputs + outputs (unfused)
    write_bytes: float = 0.0          # outputs of the ops that compute
    saved_bytes: float = 0.0          # peak held for backward, inputs excluded
    kernels: dict = dataclasses.field(default_factory=dict)      # name -> calls
    mutated: list = dataclasses.field(default_factory=list)      # input index -> bool

    def _bump(self, prim: str, flops: float) -> None:
        self.flops += flops
        self.by_prim[prim] = self.by_prim.get(prim, 0.0) + flops

    def merge(self, other: "Counts") -> None:
        self.flops += other.flops
        self.mem_bytes += other.mem_bytes
        self.transcendentals += other.transcendentals
        for k, v in other.by_prim.items():
            self.by_prim[k] = self.by_prim.get(k, 0.0) + v
        self.host_prims.extend(other.host_prims)
        self.while_loops += other.while_loops
        for u in other.unknown:
            if u not in self.unknown:
                self.unknown.append(u)
        self.io_bytes += other.io_bytes
        self.write_bytes += other.write_bytes
        self.saved_bytes += other.saved_bytes
        for k, v in other.kernels.items():
            self.kernels[k] = self.kernels.get(k, 0) + v

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "mem_bytes": self.mem_bytes,
            "transcendentals": self.transcendentals,
            "by_prim": dict(sorted(self.by_prim.items())),
            "host_prims": [list(h) for h in self.host_prims],
            "while_loops": self.while_loops,
            "unknown": sorted(self.unknown),
            "io_bytes": self.io_bytes,
            "write_bytes": self.write_bytes,
            "saved_bytes": self.saved_bytes,
            "kernels": dict(sorted(self.kernels.items())),
        }


def _nbytes(t) -> float:
    return float(t.numel() * t.element_size()) if isinstance(t, torch.Tensor) else 0.0


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _numel(t) -> float:
    return float(t.numel())


def _source() -> str:
    """The port's source line that issued the current op."""
    for fr in reversed(traceback.extract_stack()):
        f = fr.filename.replace("\\", "/")
        if "/repro_torch/" in f and "/analysis/cert/" not in f:
            return f"{f.split('/repro_torch/')[-1]}:{fr.lineno}"
    return "<program>"


def _conv_flops(out, weight) -> float:
    return 2.0 * _numel(out) * math.prod(int(n) for n in weight.shape[1:])


def _matmul_flops(name: str, args, out) -> float:
    if name in ("mm", "bmm", "mv"):
        k = args[0].shape[-1]
    elif name in ("addmm", "baddbmm", "addbmm", "addmv"):
        k = args[1].shape[-1]
    else:                                       # dot, vdot
        k = args[0].numel()
    return 2.0 * _numel(out) * float(k)


def _stand_in(name: str, args) -> Any:
    """The largest output of a host op whose size depends on the data."""
    x = args[0]
    if name in ("_local_scalar_dense", "item"):
        return False if x.dtype == torch.bool else (0.0 if x.is_floating_point() else 0)
    if name in ("is_nonzero", "equal"):
        return False
    if name == "nonzero":
        return torch.zeros((x.numel(), x.dim()), dtype=torch.int64, device=x.device)
    # masked_select, and any other op whose output size the data decides
    return torch.zeros((x.numel(),), dtype=x.dtype, device=x.device)


class _Counter(TorchDispatchMode):
    """Sees every aten op above the fake mode and counts it."""

    def __init__(self, counts: Counts, inputs: list) -> None:
        super().__init__()
        self.counts = counts
        self.input_storages = {}
        for i, t in enumerate(inputs):
            self.input_storages.setdefault(StorageWeakRef(t.untyped_storage()), []).append(i)
        self.mutated = set()
        self.paused = False

    def _writes(self, func, args, kwargs) -> None:
        schema = func._schema
        for i, a in enumerate(schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            v = args[i] if i < len(args) else kwargs.get(a.name)
            for t in _tensors(v):
                for j in self.input_storages.get(StorageWeakRef(t.untyped_storage()), ()):
                    self.mutated.add(j)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        c = self.counts
        if name in _FREE or self.paused:
            return func(*args, **kwargs)
        self._writes(func, args, kwargs)
        if name in _HOST or (name in ("_to_copy", "copy_") and _crosses_devices(name, args,
                                                                                 kwargs)):
            c.host_prims.append([_source(), f"aten.{name}"])
            if name in _HOST:
                try:
                    return func(*args, **kwargs)
                except Exception:                               # data-dependent output
                    return _stand_in(name, args)
        try:
            out = func(*args, **kwargs)
        except (torch._subclasses.fake_tensor.DynamicOutputShapeException,
                torch._subclasses.fake_tensor.DataDependentOutputException) as exc:
            c.host_prims.append([_source(), f"aten.{name} ({type(exc).__name__})"])
            return _stand_in(name, args)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        in_b, out_b = sum(map(_nbytes, ins)), sum(map(_nbytes, outs))
        if func.is_view or torch.Tag.inplace_view in func.tags:
            return out
        c.io_bytes += in_b + out_b
        if name in _MATMUL:
            c._bump(name, _matmul_flops(name, args, outs[0]))
        elif name == "convolution":
            c._bump(name, _conv_flops(outs[0], args[1]))
        elif name == "convolution_backward":
            flops = _conv_flops(args[0], args[2])
            mask = args[-1]
            c._bump(name, flops * (int(bool(mask[0])) + int(bool(mask[1])))
                    + (_numel(args[0]) if mask[2] else 0.0))
        elif name.startswith("_foreach_"):
            n = sum(_numel(t) for t in outs) or sum(_numel(t) for t in _tensors(args[0]))
            c._bump(name, n)
            if name[len("_foreach_"):].rstrip("_") in _TRANSCENDENTAL:
                c.transcendentals += n
        elif name.rstrip("_") in _SCATTER_ADD or name in _SCATTER_ADD:
            c.mem_bytes += in_b + out_b
            upd = ins[-1] if ins else None
            c._bump(name.rstrip("_"), _numel(upd) if upd is not None else 0.0)
        elif name in _MOVEMENT or name.rstrip("_") in _MOVEMENT:
            c.mem_bytes += in_b + out_b
            return out
        elif torch.Tag.pointwise in func.tags:
            n = max((_numel(t) for t in outs), default=0.0)
            base = name.rstrip("_")
            c._bump(base, n)
            if base in _TRANSCENDENTAL:
                c.transcendentals += n
        elif torch.Tag.reduction in func.tags or name in _REDUCE:
            c._bump(name, _numel(ins[0]) if ins else 0.0)
        else:
            if name not in c.unknown:
                c.unknown.append(name)
            return out
        c.write_bytes += out_b
        return out


def _crosses_devices(name: str, args, kwargs) -> bool:
    if name == "_to_copy":
        dev = kwargs.get("device")
        return dev is not None and torch.device(dev) != args[0].device
    return args[0].device != args[1].device


class _CountedKernel(torch.autograd.Function):
    """A kernel call under grad, as the port runs it: the forward counted
    by its declared cost, the backward as the port's backward (the flash
    backward kernel by its declared cost; a scan's chunked form recomputed
    under autograd, op by op)."""

    @staticmethod
    def forward(ctx, name, kw, hook, *args):
        ctx.name, ctx.kw, ctx.hook = name, kw, hook
        ctx.save_for_backward(*args)
        return hook.outputs(name, args)[0]

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        if ctx.name == "flash_attention":
            grads = ctx.hook.report("flash_attention_bwd", saved, ctx.kw)
        elif ctx.name == "rwkv6_wkv":
            from repro_torch.kernels.rwkv6_scan import wkv_chunked_grads
            grads = wkv_chunked_grads(saved, ctx.kw["grad_chunk"], dy)
        else:
            from repro_torch.kernels.mamba2_ssd import ssd_chunked_grads
            grads = ssd_chunked_grads(saved, ctx.kw["chunk"], dy)
        return (None, None, None, *grads)


class _Hook:
    """``kernels.ops.count_hook`` while a program is counted: each kernel
    call adds its declared cost to ``counts`` and gets fake outputs, made
    while ``counter`` (the program's op counter, if any) looks away."""

    def __init__(self, counts: Counts, counter: "_Counter | None" = None) -> None:
        self.counts, self.counter = counts, counter

    def outputs(self, name: str, args: tuple) -> list:
        paused = self.counter is not None and not self.counter.paused
        if paused:
            self.counter.paused = True
        try:
            return [torch.empty(s, dtype=d) for s, d in kcost.call_outputs(name, args)]
        finally:
            if paused:
                self.counter.paused = False

    def report(self, name: str, args: tuple, kw: dict) -> list:
        c = self.counts
        cost = kcost.call_cost(name, args, kw)
        c._bump(f"kernel:{name}", cost.flops)
        c.by_prim[f"kernel_matmul:{name}"] = (c.by_prim.get(f"kernel_matmul:{name}", 0.0)
                                              + cost.matmul_flops)
        c.io_bytes += cost.bytes
        c.write_bytes += cost.bytes_written
        c.kernels[name] = c.kernels.get(name, 0) + 1
        return self.outputs(name, args)

    def __call__(self, name: str, args: tuple, kw: dict):
        for t in args:
            if isinstance(t, torch.Tensor) and not isinstance(
                    t, torch._subclasses.fake_tensor.FakeTensor):
                raise RuntimeError(
                    f"the cost counter's hook got a real tensor for {name} "
                    f"({t.device}, {tuple(t.shape)}): it counts fake tensors only and never "
                    "stands in for a launch")
        grad = torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in args)
        if grad and name != "decode_attention":
            # the backward comes through _CountedKernel; its forward reports here
            self.report(name, args, kw)
            return _CountedKernel.apply(name, kw, self, *args)
        return self.report(name, args, kw)[0]


@contextlib.contextmanager
def counting(counts: Counts, counter: "_Counter | None" = None):
    """``kernels.ops.count_hook`` set to count into ``counts``."""
    prev = kops.count_hook
    kops.count_hook = _Hook(counts, counter)
    try:
        yield
    finally:
        kops.count_hook = prev


def _fake_like(mode, tree):
    """``tree`` with every tensor a fake one of ``mode`` (meta tensors
    become fake CPU tensors of their shape and dtype)."""
    def conv(x):
        if not isinstance(x, torch.Tensor):
            return x
        if isinstance(x, torch._subclasses.fake_tensor.FakeTensor):
            return x
        if x.device.type == "meta":
            with mode:
                out = torch.empty(x.shape, dtype=x.dtype)
            return out.requires_grad_(x.requires_grad)
        return mode.from_tensor(x)
    return tree_map(conv, tree)


def count_program(fn: Callable, *args, mode=None, **kwargs) -> tuple[Counts, Any]:
    """Run ``fn(*args, **kwargs)`` on fake tensors and count it.  Real or
    meta tensors among the arguments become fake ones first (tensors the
    program closes over, such as weights, become fake as they are met).
    Returns the counts and the program's (fake) outputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = mode or FakeTensorMode(allow_non_fake_inputs=True)
    fargs, fkw = _fake_like(mode, (args, kwargs))
    inputs = _tensors((fargs, fkw))
    counts = Counts()
    input_storages = {StorageWeakRef(t.untyped_storage()) for t in inputs}
    live: dict = {}                  # storage -> [saved tensors alive, bytes]
    held = {"now": 0.0, "peak": 0.0}

    def release(key) -> None:
        ent = live[key]
        ent[0] -= 1
        if ent[0] == 0:
            held["now"] -= ent[1]
            del live[key]

    def pack(t):
        key = StorageWeakRef(t.untyped_storage())
        if key in input_storages:
            return t
        ent = live.get(key)
        if ent is None:
            ent = live[key] = [0, float(t.untyped_storage().nbytes())]
            held["now"] += ent[1]
            held["peak"] = max(held["peak"], held["now"])
        ent[0] += 1
        weakref.finalize(t, release, key)
        return t

    counter = _Counter(counts, inputs)
    with counting(counts, counter), mode, counter, torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        out = fn(*fargs, **fkw)
    counts.saved_bytes = held["peak"]
    counts.mutated = [i in counter.mutated for i in range(len(inputs))]
    return counts, out


def program_io_bytes(args, out) -> tuple[float, float]:
    """(input_bytes, output_bytes) of a whole program: the memory a
    perfectly fused executable must still touch, and therefore the bytes
    term that keeps the roofline a floor."""
    return (float(sum(map(_nbytes, _tensors(args)))),
            float(sum(map(_nbytes, _tensors(out)))))
