"""The readings that a cell's limits are set from, at the cell's own size, on
the card, in one process:

    python3 portbench/tools/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 3 4 5 [--faults half_batch wkv_dlogw] [--window 6]

For each ``--seeds`` seed, the program's numbers (the lower reading is
their largest).  For each ``--control-seeds`` seed, the control's: the
reference in float8 e4m3 products put in the program's place, judged by
the same comparison against the float32 reference.  For a ``train`` cell,
``--faults`` also reads the program with each fault of ``FAULTS`` planted,
on the control seeds.  An ``infer`` cell warms up the mix's lengths, then
serves a short window of ``--window`` seconds at the cell's own load
(long enough to finish as many requests as a run judges) before its
sample is judged, as a run does.  One JSON line per reading on standard
output.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.kinds import infer, train  # noqa: E402
from portbench.reference.common import Numerics  # noqa: E402


@contextlib.contextmanager
def _patched(owner, name: str, value):
    old = owner.__dict__[name]
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def half_batch():
    """Half of each batch left out of the loss, the mean taken over the rest."""
    from repro_torch.models import Model

    whole = Model.loss

    def half(self, params, batch):
        return whole(self, params, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    return _patched(Model, "loss", half)


def wkv_dlogw():
    """The WKV scan's backward returns no gradient for the decay (dlogw
    zeroed where it is produced); the forward and the other gradients are
    untouched."""
    from repro_torch.kernels.rwkv6_scan import RWKV6WKV

    whole = RWKV6WKV.backward

    def no_decay_grad(ctx, dy):
        g = list(whole(ctx, dy))
        if g[3] is not None:
            g[3] = torch.zeros_like(g[3])
        return tuple(g)

    return _patched(RWKV6WKV, "backward", staticmethod(no_decay_grad))


FAULTS = {"half_batch": half_batch, "wkv_dlogw": wkv_dlogw}


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def infer_readings(cell, seed: int, device, window: float, control: bool) -> None:
    t = time.perf_counter()
    model, params, reqs = infer.prepare(cell, seed, device)
    infer.warm(model, params, reqs, device)
    served = infer.serve(model, params, reqs, device, window)
    del model, params
    harness.free(device)
    idx = infer.sample(served.lengths, seed, cell.traffic["check_requests"])
    refs = infer.reference_logits(cell, seed, device, reqs, idx, Numerics())
    outs = {i: served.outputs[i] for i in idx}
    _emit(cell=cell.name, seed=seed, side="program", readings=infer.readings(outs, refs),
          requests=len(served.outputs), seconds=time.perf_counter() - t)
    if control:
        t = time.perf_counter()
        ctl = infer.reference_logits(cell, seed, device, reqs, idx, Numerics(fp8=True))
        _emit(cell=cell.name, seed=seed, side="control", readings=infer.readings(ctl, refs),
              seconds=time.perf_counter() - t)


def _program(cell, seed: int, device) -> dict:
    job = train.Job(cell, seed, device)
    rec = job.checked_steps(cell.traffic["checked_steps"])
    del job
    harness.free(device)
    return rec


def train_readings(cell, seed: int, device, control: bool, faults: list) -> None:
    n = cell.traffic["checked_steps"]
    t = time.perf_counter()
    prog = _program(cell, seed, device)
    t_prog = time.perf_counter() - t
    ref = train.reference(cell, seed, device, n, Numerics())
    _emit(cell=cell.name, seed=seed, side="program", readings=train.readings(prog, ref),
          losses=prog["losses"], ref_losses=ref["losses"], program_seconds=t_prog,
          reference_seconds=time.perf_counter() - t - t_prog)
    if control:
        ctl = train.reference(cell, seed, device, n, Numerics(fp8=True))
        _emit(cell=cell.name, seed=seed, side="control", readings=train.readings(ctl, ref),
              losses=ctl["losses"])
    for fault in faults:
        with FAULTS[fault]():
            bad = _program(cell, seed, device)
        _emit(cell=cell.name, seed=seed, side=f"fault:{fault}",
              readings=train.readings(bad, ref), losses=bad["losses"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[],
                    help="seeds of --seeds on which the control (and faults) are read too")
    ap.add_argument("--faults", nargs="*", default=[], choices=sorted(FAULTS))
    ap.add_argument("--window", type=float, default=6.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("calibrate: needs a CUDA card\n")
        return 2
    device = torch.device("cuda:0")
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        control = seed in args.control_seeds
        if cell.kind == "infer":
            infer_readings(cell, seed, device, args.window, control)
        else:
            train_readings(cell, seed, device, control, args.faults if control else [])
    return 0


if __name__ == "__main__":
    sys.exit(main())
