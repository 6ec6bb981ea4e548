"""Smoke-sized configurations for the CPU tests of the benchmark: the two
families of its cells at widths a CPU test holds, in the ``port`` layout
of a configuration file."""

from __future__ import annotations

import copy
import json

from chipbench import common

DENSE = {"name": "dense-smoke", "family": "dense", "num_layers": 2,
         "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab_size": 500, "vocab_pad_to": 128,
         "attention_type": "gqa", "rope_type": "rope", "rope_theta": 10000.0,
         "mlp_type": "swiglu", "norm_type": "rmsnorm", "norm_eps": 1e-05,
         "tie_embeddings": True, "dtype": "bfloat16",
         "param_dtype": "float32"}
HYBRID = dict(DENSE, name="hybrid-smoke", family="hybrid", num_layers=3,
              num_kv_heads=4, tie_embeddings=False,
              ssm={"state_dim": 16, "head_dim": 16, "expand": 2,
                   "conv_width": 4, "chunk_size": 16, "n_groups": 1},
              hybrid={"attn_every": 2, "num_shared_blocks": 2})
PORTS = {"dense": DENSE, "hybrid": HYBRID}
# a large seed, beyond what 32 signed bits hold
SEED = 2 ** 33 + 12345


def port(family: str, **over) -> dict:
    out = copy.deepcopy(PORTS[family])
    out.update(over)
    return out


def traffic(name: str = "train-2k", **over) -> dict:
    """A traffic file cut to a CPU test's size."""
    out = common.traffic_file(name)
    out.update({"seq_len": 32, "global_batch": 4})
    out.update(over)
    return out


def cell_for(family: str) -> str:
    """The benchmark cell whose configuration is of ``family``."""
    bench = common.benchmark()
    for w in bench["workloads"]:
        if common.config_file(w["config"], bench)["port"]["family"] \
                == family:
            return w["name"]
    raise KeyError(family)


def write_json(path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))
