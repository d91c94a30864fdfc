"""Scale-out over several cards on the packet axis."""

from .mesh import ShardedBatchDecoder, make_packet_mesh

__all__ = ["ShardedBatchDecoder", "make_packet_mesh"]
