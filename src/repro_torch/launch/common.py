"""What the two entry points share: the stack and peak flags and their reading."""

from __future__ import annotations

import argparse
import os

from repro_torch.train.loop import _known_peaks, device_peaks


def add_stack_args(ap: argparse.ArgumentParser) -> None:
    url = os.environ.get("LMS_URL")
    ap.add_argument("--lms-url", default=url, required=not url,
                    help="URL of the monitoring stack this job reports to "
                         "(default: $LMS_URL)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; pass cpu "
                         "to run the plain versions on the CPU)")
    ap.add_argument("--peak-flops", type=float, default=None,
                    help="device peak FLOP/s (default: the card's published "
                         "bf16 peak; required off a known card)")
    ap.add_argument("--hbm-bw", type=float, default=None,
                    help="device memory bytes/s (default: the card's "
                         "published rate; required off a known card)")
    ap.add_argument("--ici-bw", type=float, default=None,
                    help="interconnect bytes/s a card sends (default: the "
                         "card's published one-direction NVLink rate; off "
                         "a known card the ICI utilisations are skipped)")


def resolve_peaks(args, device) -> tuple:
    """(peak FLOP/s, memory bytes/s, interconnect bytes/s or None): the
    flags where given, else the card's published peaks (raises for a
    device without them, unless the first two are given)."""
    if args.peak_flops is not None and args.hbm_bw is not None:
        known = _known_peaks(device)
        ici = args.ici_bw if args.ici_bw is not None else (
            known[2] if known else None)
        return args.peak_flops, args.hbm_bw, ici
    pf, bw, ici = device_peaks(device)
    return (pf if args.peak_flops is None else args.peak_flops,
            bw if args.hbm_bw is None else args.hbm_bw,
            ici if args.ici_bw is None else args.ici_bw)
