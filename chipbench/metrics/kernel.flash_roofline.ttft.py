"""The flash attention kernel's share of its roofline over the traced
batches' prefills: each call's bound (``costs.flash_cost`` at the batch's
(b, heads, kv heads, prompt length, head dim) causal shape, bf16; inputs
read once, output written once) over the device time of the flash kernels
in the trace.  Calls are the model's layers a batch, held to the program's
``launch_counts()``; where they disagree, nothing is read."""

import sys

from chipbench import costs

UNIT = "%"
KERNELS = ("flash_wgmma_kernel", "flash_f32_kernel")


def read(run: dict):
    t = run.get("trace")
    if run.get("kind") != "serve" or not t or not run["traced_batches"]:
        return None
    times = [s for n, s in t["ops"] if any(k in n for k in KERNELS)]
    port = run["port"]
    calls = port["num_layers"] * len(run["traced_batches"])
    launches = (run.get("launches") or {}).get("flash_attention")
    if not times or len(times) != calls or launches != calls:
        print(f"kernel.flash_roofline.ttft: {len(times)} kernels, "
              f"{launches} launches, {calls} calls expected",
              file=sys.stderr)
        return None
    bound = sum(port["num_layers"] * costs.bound_s(costs.flash_cost(
        b, port["num_heads"], port["num_kv_heads"], plen, port["head_dim"],
        2), run["peaks"]) for b, plen in run["traced_batches"])
    return 100.0 * bound / sum(times)
