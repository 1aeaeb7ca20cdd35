"""Counterparts of ``experiments/pallas_probe.py`` and
``experiments/resident_iter_proto.py``: the two probes whose TPU kernels
(K2, K3) the port runs as CUDA C++ kernels.  Each has a function that
returns its rows and a ``python -m`` entry point that prints them."""
