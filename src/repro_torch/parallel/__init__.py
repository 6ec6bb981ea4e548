"""Distribution on ``torch.distributed`` (port of ``repro.parallel``):
logical-axis sharding rules, the collectives over a mesh's named axes, and
the GPipe pipeline."""

from repro_torch.parallel.sharding import (
    NullConstraints,
    PartitionConstraints,
    SERVE_RULES,
    ShardingRules,
    TRAIN_RULES,
    logical_to_pspec,
    rules_for,
    shardings_for_specs,
)

__all__ = [
    "NullConstraints",
    "PartitionConstraints",
    "ShardingRules",
    "TRAIN_RULES",
    "SERVE_RULES",
    "logical_to_pspec",
    "shardings_for_specs",
    "rules_for",
]
