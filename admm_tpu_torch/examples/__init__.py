"""The port's examples (counterparts of the repository's ``examples/``,
which stay ``admm_tpu``'s).  Each is a module with a function to call and
a ``python -m admm_tpu_torch.examples.<name>`` entry point; each solves on
the card unless given ``device=``.  Ported: acceleration,
convergencechecking, distributed_matrix, fasteradmmcomparison, hnormdemo,
hypergradient (tuning and ``consensus_hypergradient``), maxcut, mnistsvm,
mpc_qp, multihost_smoke, portfolio, relaxationexample, stepsizetesting and
unwrappedadmmtest.  The mesh examples take ``mesh=``: stacked shards on
one device, or a process group's ``parallel.global_mesh()``."""
