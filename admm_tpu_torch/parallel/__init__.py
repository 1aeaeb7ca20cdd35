"""The distributed layer (port of ``admm_tpu/parallel/``).

``admm_tpu`` writes each distributed solver as one program over stacked
(W, ...) arrays and places the leading axis on a device mesh (GSPMD),
where the reference's broadcast/gather/all-reduce patterns become
psum/pmean collectives.  The port keeps that program and runs its W
shards stacked on one device (``mesh.Mesh``): each psum/pmean over the
mesh axis is a sum/mean over dim 0 at the same place in the update.
Placing the shard axis over processes with ``torch.distributed`` is
ROADMAP.md queue 1, slice 10b (``initialize_cluster`` and ``global_mesh``
raise until then).

Three distributed forms:

- consensus ADMM (global-variable LASSO, elastic net, logistic
  regression, covariance selection, and their lanes x shards batches):
  ``consensus``
- transpose-reduction unwrapped ADMM (SVM): ``transpose_reduction``
- exchange ADMM (sum-coupled agents): ``exchange``
- the sharded SDP over the core engine: ``sdp``
- engine-generic sliced proximal updates (even or uneven slices,
  'xminf'/'zming'/'both'): ``sliced.make_sliced_prox``,
  ``sliced.make_parallel_proxes``
"""

from .mesh import Mesh, make_mesh, make_mesh2d, pad_rows, shard_rows
from .consensus import (consensus_admm, consensus_covsel, consensus_covsel_batch,
                        consensus_elasticnet, consensus_elasticnet_batch, consensus_lasso,
                        consensus_lasso_batch, consensus_logreg)
from .transpose_reduction import linearsvm_sharded, svm_batch_sharded, unwrapped_admm_sharded
from .exchange import exchange_admm, exchange_quadratic
from .sdp import sdp_sharded
from .sliced import make_parallel_proxes, make_sliced_prox
from .multihost import global_mesh, initialize_cluster

__all__ = [
    "initialize_cluster",
    "global_mesh",
    "make_mesh",
    "make_mesh2d",
    "pad_rows",
    "shard_rows",
    "consensus_admm",
    "consensus_covsel",
    "consensus_covsel_batch",
    "sdp_sharded",
    "exchange_admm",
    "exchange_quadratic",
    "consensus_elasticnet",
    "consensus_lasso",
    "consensus_lasso_batch",
    "consensus_elasticnet_batch",
    "consensus_logreg",
    "unwrapped_admm_sharded",
    "linearsvm_sharded",
    "svm_batch_sharded",
    "make_parallel_proxes",
    "make_sliced_prox",
]
