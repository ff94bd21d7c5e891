"""tvcert CLI — static timing certification gate.

    python -m repro_torch.analysis.cert --check            # the gate (default), CPU
    python -m repro_torch.analysis.cert --regen --measure  # recount + remeasure on the card
    python -m repro_torch.analysis.cert --check --diff-out cert_diff.txt

``--check`` recounts the shipped tree on fake tensors (no arithmetic, no
card) and compares it with the committed ``analysis/torch_certificate.json``;
exit 1 on any fatal finding (capture violation, signature/envelope drift,
new host op, in-place-write mismatch, roofline-vs-prior drift beyond
±25%).  ``--regen`` rebuilds the static sections and refreshes the
calibrated priors, then rewrites the certificate; with ``--measure`` (the
card only) it also measures every (rung, batch size) step on the card and
stores the card's name and power limit beside the times.  Review the diff
and commit it, golden-fixture style.  Exit codes: 0 clean, 1 findings, 2
usage/environment error (e.g. no committed certificate, ``--measure``
without a card).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

from .certificate import (DEFAULT_CERT_PATH, DRIFT_TOL, attach_measured, build_static, check,
                          intrinsic_findings, load_certificate, render_report,
                          write_certificate)


def card_identity() -> dict:
    """The card's name and power limit, as nvidia-smi reports them."""
    import torch

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "nvidia-smi unavailable"
    return {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.cert",
                                 description="static timing certifier (tvcert)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_true",
                      help="verify the committed certificate against the shipped tree "
                           "(default)")
    mode.add_argument("--regen", action="store_true",
                      help="recount, recalibrate the priors, rewrite the certificate")
    ap.add_argument("--measure", action="store_true",
                    help="with --regen: measure each (rung, batch size) step on the card")
    ap.add_argument("--cert", default=str(DEFAULT_CERT_PATH),
                    help="certificate path (default: %(default)s)")
    ap.add_argument("--tol", type=float, default=DRIFT_TOL,
                    help="relative drift tolerance for the prior/floor ratio gate "
                         "(default: %(default)s)")
    ap.add_argument("--diff-out", default=None, metavar="PATH",
                    help="also write the human-readable report to PATH")
    ap.add_argument("--quiet", action="store_true", help="suppress the report on stdout")
    args = ap.parse_args(argv)

    cert_path = Path(args.cert)
    if args.measure and not args.regen:
        sys.stderr.write("--measure belongs to --regen\n")
        return 2

    if args.regen:
        card = None
        device = "cpu"
        if args.measure:
            import torch

            if not torch.cuda.is_available():
                sys.stderr.write("--measure needs a CUDA device\n")
                return 2
            device, card = "cuda", card_identity()
        cert = build_static()
        attach_measured(cert, measure=args.measure, device=device, card=card)
        problems = intrinsic_findings(cert)
        if args.measure:
            problems += [f"FLOOR {r['rung']}/batch{r['batch_size']}: floor "
                         f"{r['floor_s'] * 1e3:.4f}ms above the measured "
                         f"{r['bench_p50_s'] * 1e3:.4f}ms"
                         for r in cert["cost_table"] if r["floor_s"] > r["bench_p50_s"]]
        write_certificate(cert, cert_path)
        report = render_report(problems, [])
        if not args.quiet:
            rows = [f"  {r['rung']}/batch{r['batch_size']}: floor {r['floor_s'] * 1e3:.4f} ms, "
                    f"prior {r['prior_s'] * 1e3:.4f} ms"
                    + (f", measured {r['bench_p50_s'] * 1e3:.4f} ms, floor/measured "
                       f"{r['floor_s'] / r['bench_p50_s']:.4f}"
                       if r["bench_p50_s"] is not None else "")
                    for r in cert["cost_table"]]
            sys.stdout.write(f"wrote {cert_path}" + (f" ({card})" if card else "") + "\n"
                             + "\n".join(rows) + "\n" + report)
        if args.diff_out:
            Path(args.diff_out).write_text(report)
        return 1 if problems else 0

    if not cert_path.exists():
        sys.stderr.write(f"no certificate at {cert_path} — run --regen first\n")
        return 2
    committed = load_certificate(cert_path)
    fresh = build_static()
    fatal, notes = check(committed, fresh, tol=args.tol)
    report = render_report(fatal, notes)
    if not args.quiet:
        sys.stdout.write(report)
    if args.diff_out:
        Path(args.diff_out).write_text(report)
    return 1 if fatal else 0


if __name__ == "__main__":
    sys.exit(main())
