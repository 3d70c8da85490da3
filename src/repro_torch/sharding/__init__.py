"""Sharding rules of the port (``repro.sharding``)."""
from repro_torch.sharding.rules import (  # noqa: F401
    Constrainer,
    P,
    PartitionSpec,
    ShardingRules,
    batch_pspec,
    cache_pspecs,
    make_constrain,
    param_pspecs,
    shard_leaf,
)
