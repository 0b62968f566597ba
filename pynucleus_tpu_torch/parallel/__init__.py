"""Distribution over a single-controller shard mesh (port of
pynucleus_tpu/parallel): n shards stacked per card, collectives over the
shard axis, the sharded dense assembly, the row-sharded, distributed H2
and distributed CSR operators, index maps and overlaps."""
from .dist import (  # noqa: F401
    makeDeviceMesh, shardedDenseAssembly, rowShardedOperator,
    distributedSolveStep)
from .dist_h2 import (  # noqa: F401
    DistributedH2Matrix, DistributedCSROperator)

__all__ = ['makeDeviceMesh', 'shardedDenseAssembly', 'rowShardedOperator',
           'distributedSolveStep', 'DistributedH2Matrix',
           'DistributedCSROperator']
