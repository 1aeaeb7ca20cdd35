"""The port's examples (counterparts of the repository's ``examples/``,
which stay ``admm_tpu``'s).  Each is a module with a function to call and
a ``python -m admm_tpu_torch.examples.<name>`` entry point."""
