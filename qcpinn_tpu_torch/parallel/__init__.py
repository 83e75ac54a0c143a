"""The parallel layer (port of qcpinn_tpu/parallel): the ('data', 'amp')
mesh on ``torch.distributed`` and the two amplitude-sharded engines
(``sharded_sv``, ``sharded_block``)."""

from .mesh import batch_sharding, make_mesh, replicate, shard_batch

__all__ = ["batch_sharding", "make_mesh", "replicate", "shard_batch"]
