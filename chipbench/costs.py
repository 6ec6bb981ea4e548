"""The yardstick's arithmetic: peaks, operations and bytes, parameter counts.

Frozen copies of the port's kernel cost models (``repro_torch.kernels``:
``flash_attention.cost_estimate``, ``ssd.cost_estimate`` /
``bwd_cost_estimate``, ``rmsnorm.cost_estimate`` / ``bwd_cost_estimate``),
so no change to the program can move the bound a roofline share is read
against.  Each counts the work the function needs from its shapes: every
input byte read once, every output byte written once.  The parameter count
behind ``6 N T`` / ``2 N T`` is the benchmark's own, from the configuration
file's ``port`` section, by the family's module.
"""

from __future__ import annotations

from chipbench import common

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W): bf16 FLOP/s on
# the tensor cores and HBM bytes/s.
PEAKS = {"H100": {"flops": 989e12, "bytes": 3.35e12}}

SSD_CHUNK = 64          # the SSD kernel's chunk (``kernels.ssd.CHUNK``)


def peaks_for(kind: str) -> dict:
    """The published peaks of a card by its name; raises for another."""
    for key, p in PEAKS.items():
        if key in kind:
            return p
    raise ValueError(f"no published peaks for {kind!r}")


def bound_s(cost: dict, peaks: dict) -> float:
    """The least time the card could take: the larger of operations over
    peak FLOP/s and bytes over peak bytes/s."""
    return max(cost["flops"] / peaks["flops"], cost["bytes"] / peaks["bytes"])


# -- flash attention ---------------------------------------------------------

def attended_pairs(s: int, *, causal: bool, window: int = 0) -> int:
    """(query, key) pairs the masks leave, per (batch, head)."""
    if not causal and not window:
        return s * s
    if not window:
        return s * (s + 1) // 2
    total = 0
    for r in range(s):
        lo = max(0, r - window + 1)
        hi = r + 1 if causal else s
        total += max(0, hi - lo)
    return total


def flash_cost(b: int, h: int, kv: int, s: int, d: int, itemsize: int, *,
               causal: bool = True, window: int = 0) -> dict:
    """One call of causal attention over (b, h, s, d) queries and kv heads:
    2*D for Q K^T and 2*D for P V per attended pair; q, k, v read once and
    o written once."""
    pairs = attended_pairs(s, causal=causal, window=window)
    return {"flops": 2.0 * b * h * 2 * d * pairs,
            "bytes": float(b * s * (h + kv) * 2 * d * itemsize)}


# -- SSD chunk scan ------------------------------------------------------------

def causal_pairs(l: int, chunk: int = SSD_CHUNK) -> int:
    """(i, j) pairs with j <= i inside the chunks of ``l`` steps."""
    full, tail = divmod(int(l), chunk)
    return full * chunk * (chunk + 1) // 2 + tail * (tail + 1) // 2


def ssd_cost(b: int, h: int, l: int, p: int, groups: int, n: int,
             itemsize: int, *, init_state: bool = False) -> dict:
    """One forward call: the within-chunk pair (C B^T, then P x: 2*(N+P) a
    causal pair) and the state pair (C S and B^T x: 2*N*P each) a step;
    x, a, b/c (once a group) and the initial state read, y and the final
    state written."""
    flops = float(b * h) * (2.0 * (n + p) * causal_pairs(l)
                            + 4.0 * n * p * l)
    elems = b * h * l * 2 * p + b * groups * l * 2 * n
    state = b * h * p * n * 4 * (2 if init_state else 1)
    return {"flops": flops,
            "bytes": float(elems * itemsize + b * h * l * 4 + state)}


def ssd_bwd_cost(b: int, h: int, l: int, p: int, groups: int, n: int,
                 itemsize: int, *, init_state: bool = False) -> dict:
    """One backward call: five within-chunk products (2*(3N + 2P) a causal
    pair), the four state products and the chunk-start recompute (10*N*P a
    step); x, dy, a, b/c and the initial state read, dx, da, db/dc and its
    gradient written."""
    flops = float(b * h) * (2.0 * (3 * n + 2 * p) * causal_pairs(l)
                            + 10.0 * n * p * l)
    elems = b * h * l * 3 * p + b * groups * l * 4 * n
    state = b * h * p * n * 4 * 2 if init_state else 0
    return {"flops": flops,
            "bytes": float(elems * itemsize + b * h * l * 4 * 2 + state)}


# -- RMSNorm ---------------------------------------------------------------------

def rmsnorm_cost(rows: int, d: int, itemsize: int) -> dict:
    return {"flops": 4.0 * rows * d,
            "bytes": float(2 * rows * d * itemsize + 4 * d)}


def rmsnorm_bwd_cost(rows: int, d: int, itemsize: int) -> dict:
    return {"flops": 10.0 * rows * d,
            "bytes": float(3 * rows * d * itemsize + 8 * d)}


# -- parameters ------------------------------------------------------------------

def attn_block_params(port: dict) -> int:
    """One pre-norm attention block: its projections, its MLP and its two
    norms."""
    d, h = port["d_model"], port["num_heads"]
    kv, hd = port["num_kv_heads"], port["head_dim"]
    mats = 3 if port["mlp_type"] == "swiglu" else 2
    return d * h * hd + 2 * d * kv * hd + h * hd * d \
        + mats * d * port["d_ff"] + 2 * d


def head_params(port: dict) -> int:
    """The final norm and the output head at the published vocabulary (a
    tied embedding counts once, as the head; an untied input table, only
    looked up, not at all)."""
    return port["d_model"] + port["vocab_size"] * port["d_model"]


def flop_params(port: dict) -> int:
    """Parameters a token is multiplied by in one forward pass, from the
    configuration as run: every layer's matrices and norms, a shared block
    once per application, the output head (:func:`head_params`); the
    family's module (``families/<family>.py``) counts them.  ``6 N T`` and
    ``2 N T`` use it."""
    return common.family(port).flop_params(port)
