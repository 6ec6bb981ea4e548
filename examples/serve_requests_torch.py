"""Serving example of the PyTorch port: batched requests through a
monitored ServingEngine on the CUDA card, reporting to a stack that runs
in another process.

    PYTHONPATH=src python examples/serve_requests_torch.py --lms-url URL

Per-request TTFT/latency and per-batch decode throughput land in the stack
as ``serve_request`` / ``serve_decode`` measurements; a serving job is
monitored exactly like a training job.  lms-demo at its full config by
default; ``--smoke --device cpu --peak-flops F --hbm-bw B`` serves the
reduced config on the CPU (its head dim has no flash instance on the card).
"""

import argparse
import os
import sys
import uuid

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RemoteStack, calibrate  # noqa: E402
from repro_torch.launch.common import (  # noqa: E402
    add_stack_args, resolve_peaks)
from repro_torch.models.transformer import init_model_params  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, for the CPU")
    add_stack_args(ap)
    args = ap.parse_args(argv)

    cfg = get_config("lms-demo", smoke=args.smoke)
    device = resolve_device(args.device)
    peak_flops, hbm_bw, _ = resolve_peaks(args, device)
    params = init_model_params(cfg, seed=0, device=device)
    stack = RemoteStack(args.lms_url)
    rng = np.random.default_rng(0)
    job_id = f"serve-demo-torch-{uuid.uuid4().hex[:8]}"

    try:
        with stack.job(job_id, user="server", hosts=["host0"]):
            um = stack.usermetric(host="host0")
            calibrate(um, peak_flops, hbm_bw)
            engine = ServingEngine(cfg, params, max_batch=4, max_len=96,
                                   usermetric=um, device=device)
            for _ in range(12):
                prompt = rng.integers(1, cfg.vocab_size, rng.integers(4, 20))
                engine.submit(prompt, max_new_tokens=12)
            done = engine.run_until_empty()
            um.flush()
    finally:
        stack.close()

    for r in done[:4]:
        print(f"req {r.rid}: {len(r.output)} tokens, "
              f"ttft {1e3 * (r.first_token_at - r.submitted_at):.1f}ms, "
              f"latency {1e3 * (r.finished_at - r.submitted_at):.1f}ms")
    agg = stack.sink.aggregate("serve_decode", "tokens_per_s", agg="mean",
                               tags={"jobid": job_id})
    print(f"\nmean decode throughput: {agg.get('', 0):.1f} tok/s")
    print(f"report: {stack.report_url(job_id)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
