# Sharded retrieval (DESIGN.md §3): contiguous row partitions over a mesh of
# local devices, per-shard scans and an exact cross-shard merge.  Importing
# this package touches no device.  ``steps`` holds the model zoo's serving
# steps and the dry-run's cells (``build_cell``, on meta tensors), whose
# partition rules are ``sharding``.
from .partition import pad_rows, partition_bounds, shard_rows, shard_sizes  # noqa: F401
from .retrieval import (make_cascade_topk_shardmap, make_scan_topk_f32_shardmap,  # noqa: F401
                        make_scan_topk_shardmap, scan_topk_f32, scan_topk_pjit)
from .sharded_index import ShardedMonaVec  # noqa: F401
