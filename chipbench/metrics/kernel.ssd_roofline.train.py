"""The SSD kernels' share of their roofline over the traced training steps:
the bound of every forward and backward call (``costs.ssd_cost`` /
``ssd_bwd_cost`` at the step's shape: inputs read once, outputs written
once), over the device time of the SSD kernels in the trace.  Calls are
counted from the trace's forward kernels (one launch a call) and held to
the program's ``launch_counts()``; where they disagree, or no SSD kernel
ran, there is nothing to read."""

import sys

from chipbench import costs

UNIT = "%"
FORWARD = ("ssd_wgmma_kernel", "ssd_f32_kernel")
BACKWARD = ("ssd_bwd_states_kernel", "ssd_bwd_wgmma_kernel",
            "ssd_bwd_group_sum_kernel", "ssd_bwd_kernel")


def _is(name: str, kinds) -> bool:
    return any(k in name for k in kinds)


def read(run: dict):
    t, port = run.get("trace"), run.get("port", {})
    if run.get("kind") != "train" or not t or "ssm" not in port:
        return None
    fwd = [s for n, s in t["ops"] if _is(n, FORWARD)]
    bwd = [s for n, s in t["ops"]
           if _is(n, BACKWARD) and not _is(n, FORWARD)]
    launches = run.get("launches") or {}
    if not fwd or len(fwd) != launches.get("ssd_scan") or \
            launches.get("ssd_scan_backward", 0) == 0:
        print(f"kernel.ssd_roofline.train: {len(fwd)} forward kernels in "
              f"the trace, launch counts {launches}", file=sys.stderr)
        return None
    s = port["ssm"]
    tr = run["traffic"]
    di = s["expand"] * port["d_model"]
    shape = (tr["global_batch"], di // s["head_dim"], tr["seq_len"],
             s["head_dim"], s["n_groups"], s["state_dim"], 2)
    bound = len(fwd) * costs.bound_s(costs.ssd_cost(*shape), run["peaks"]) \
        + launches["ssd_scan_backward"] * costs.bound_s(
            costs.ssd_bwd_cost(*shape), run["peaks"])
    return 100.0 * bound / (sum(fwd) + sum(bwd))
