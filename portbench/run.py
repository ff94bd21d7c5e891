"""Runs one cell of the benchmark once, on the card this process finds:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard output,
the result's JSON (``correct``, ``attempted``, ``failed``, ``metrics``:
the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``; ``device``; with ``--trace 1`` ``breakdown``; last,
``checks``: each compared number beside its limit), and the checks as the
last lines of standard error.  Exits non-zero, with no result, without a
CUDA card, without the program under ``src/``, or when a module of the JAX
stack or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the program builds its kernels into src/repro_torch/kernels/build/ of this
# checkout (a fixed path), so only a checkout's first run compiles
ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import importlib

    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.stderr.write(f"portbench: {args.workload} needs {chips} CUDA card(s); found {n}\n")
        return 2
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    torch.set_num_threads(1)     # one host thread: the card is driven from one
    seed = args.seed % (1 << 63)
    kind = importlib.import_module(f"portbench.kinds.{cell.kind}")
    out = kind.run(cell, seed, args.seconds, bool(args.trace), device, T0)

    correct, checks = harness.judge(out["readings"], cell.limits)
    dev = harness.device_info(device, out["memory_peak_bytes"])
    breakdown = None
    if args.trace:
        tr = out["trace"]
        metrics = harness.read_per_layer(cell, tr)
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.wall_s
        breakdown = tr.breakdown()
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in out["end_to_end"].items()
                   if k in units}
    bad = harness.forbidden_modules()
    if bad:
        sys.stderr.write(f"portbench: modules of the JAX stack or package were loaded: {bad}\n")
        return 3
    print(harness.result_line(correct, out["attempted"], out["failed"], metrics, dev, checks,
                              breakdown), flush=True)
    harness.print_checks(checks, sys.stderr.write)
    return 0


if __name__ == "__main__":
    sys.exit(main())
