"""The port's examples (counterparts of the repository's ``examples/``,
which stay ``admm_tpu``'s).  Each is a module with a function to call and
a ``python -m admm_tpu_torch.examples.<name>`` entry point; each solves on
the card unless given ``device=``.  Ported: acceleration,
convergencechecking, fasteradmmcomparison, hnormdemo, hypergradient
(tuning), maxcut, mnistsvm, mpc_qp, portfolio, relaxationexample and
stepsizetesting.  ``unwrappedadmmtest``, ``distributed_matrix``,
``multihost_smoke`` and ``consensus_hypergradient``, the mesh examples,
wait for ROADMAP.md queue 1, slice 10b."""
