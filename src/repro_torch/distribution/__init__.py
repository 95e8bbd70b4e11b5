"""Distribution layer: divisibility-aware sharding policy (TP × FSDP) as
DTensor placements, and collectives over ``torch.distributed`` process
groups (KV-seq-split flash-decoding on the decode kernel, compressed
gradient all-reduce).  The counterpart of ``repro/distribution``."""
from repro_torch.distribution.sharding import (
    ShardingPolicy, param_shardings, input_shardings, cache_shardings,
)

__all__ = ["ShardingPolicy", "param_shardings", "input_shardings",
           "cache_shardings"]
