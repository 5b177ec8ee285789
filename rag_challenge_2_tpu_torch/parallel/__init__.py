from .launch import run_ranks
from .mesh import cpu_mesh, encoder_param_spec, make_mesh, shard_params
from .pipeline import pipeline_forward
from .sharded_ivf import (
    ShardedIVF, build_shared_ivf, build_sharded_ivf, shard_ivf, sharded_ivf_search)
from .sharded_search import (
    hierarchical_dense_topk, make_hierarchical_topk, make_sharded_topk,
    shard_rows, sharded_dense_topk)
from .sharded_sparse import shard_sparse_index
