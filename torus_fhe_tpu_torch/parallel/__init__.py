"""Mesh execution: the batch-sharded gates, the party-sharded keyswitch and
threshold decryption, and the party-pipelined multikey blind rotate.

Port of torus_fhe_tpu/parallel/__init__.py: a grid of ``torch.device``s in
one process, or across processes after ``init_distributed`` (see ``mesh``).
"""

from . import mesh, mk_pipeline, sharded
from .mesh import (BATCH_AXIS, PARTY_AXIS, Mesh, init_distributed, make_mesh,
                   replicate_cloud_key, run_batch_sharded, shard_lwe_batch)
from .mk_pipeline import (build_sharded_mk_fb, build_sharded_mk_sel,
                          mk_blind_rotate_pipelined, mk_bootstrap_pipelined)
