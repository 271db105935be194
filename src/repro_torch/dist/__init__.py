"""Tier substrate (counterpart of ``repro.dist``).

``sharding`` maps logical axis names (dp / fsdp / tp / ep / edge / row)
onto the named dims of a ``DeviceMesh`` (or an abstract mesh), gives each
its process group and places tensors (``spec``/``sharding``/``constrain``);
``collectives`` holds the owner-exchange bucketing and the differentiable
exchanges and psum helpers on ``torch.distributed``; ``sharded_index`` stacks same-spec per-shard
indexes leaf-wise and answers a tier in one process (``mode="ref"``) or
one shard a rank (``"a2a"``, ``"allgather"``), and refreshes and
rebalances its shards in place; an updatable (GAPPED) tier also takes
key batches into a shard and compacts it in place.  A telemetry-on
lookup records the tier's routing counters (``tier_metrics``)."""

from . import collectives, sharded_index, sharding
from .sharded_index import (
    DROPPED,
    NO_PRED,
    ShardedIndex,
    compact_shard,
    insert_into_shard,
    rebalance_shards,
    refresh_shard,
    reset_tier_metrics,
    shard_build_table,
    shard_query_weights,
    sharded_lookup,
    stack_indexes,
    tier_metrics,
    weighted_quantile_bounds,
)
from .sharding import (
    AbstractMesh,
    CommLedger,
    NamedSharding,
    PartitionSpec,
    ShardingCtx,
    single_device_ctx,
)

__all__ = [
    "collectives",
    "sharding",
    "sharded_index",
    "AbstractMesh",
    "CommLedger",
    "NamedSharding",
    "PartitionSpec",
    "ShardingCtx",
    "single_device_ctx",
    "DROPPED",
    "NO_PRED",
    "ShardedIndex",
    "compact_shard",
    "insert_into_shard",
    "rebalance_shards",
    "refresh_shard",
    "reset_tier_metrics",
    "shard_build_table",
    "shard_query_weights",
    "sharded_lookup",
    "stack_indexes",
    "tier_metrics",
    "weighted_quantile_bounds",
]
