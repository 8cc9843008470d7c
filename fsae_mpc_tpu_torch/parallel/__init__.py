"""Scale-out over devices: the batch split into shards, metrics reduced."""

from .mesh import (make_mesh, pmean_metrics, replicate,  # noqa: F401
                   shard_batch, sharded_batch_apply)
