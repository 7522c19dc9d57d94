"""Distributed execution on ``torch.distributed`` (port of ``repro.dist``).

``repro_torch.dist.sharding`` owns the logical-axis partitioning rules the
serve engine shards its parameters and pool by, and the ambient mesh;
``repro_torch.dist.shard_gemm`` runs the integer-GEMM kernels on each
rank's block; ``repro_torch.dist.collectives`` holds the reference's
communication-efficient primitives (error-feedback int8 all-reduce, ring
all-gather matmul, split-K decode attention) and the mesh-axis collectives
under them.
"""
from repro_torch.dist import collectives, shard_gemm, sharding  # noqa: F401
