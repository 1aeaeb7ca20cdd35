"""The distributed layer (port of ``admm_tpu/parallel/``).

``admm_tpu`` writes each distributed solver as one program over stacked
(W, ...) arrays and places the leading axis on a device mesh (GSPMD),
where the reference's broadcast/gather/all-reduce patterns become
psum/pmean collectives.  The port keeps that program over a ``mesh.Mesh``:
its W shards stacked on one device, each psum/pmean over the mesh axis a
sum/mean over dim 0 at the same place in the update; or, over the ranks
of a ``torch.distributed`` process group (``initialize_cluster``,
``global_mesh``), each rank's block of shards on its own device, each
psum/pmean one all-reduce (``Mesh.psum``, ``Mesh.pmean``; the counts of
collectives and bytes in ``Mesh.stats``).  ``dryrun`` runs every form
once over a mesh.

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
