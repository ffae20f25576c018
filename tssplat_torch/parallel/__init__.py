"""Multi-rank training over ``torch.distributed`` (port of
``tssplat_tpu/parallel``): the view group (``mesh``) and row-slab spatial
sharding (``spatial``)."""

from .mesh import (BROADCAST, MEAN, SUM, VIEW_KEYS, shard_batch, sync_step)
from .spatial import (HALO, shard_spatial_train_batch, slab_rows,
                      spatial_geometry_loss)

__all__ = ["BROADCAST", "HALO", "MEAN", "SUM", "VIEW_KEYS", "shard_batch",
           "shard_spatial_train_batch", "slab_rows", "spatial_geometry_loss",
           "sync_step"]
