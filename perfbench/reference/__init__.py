"""Plain references of the benchmark's problem families.

Each is a straightforward scaled-dual ADMM in plain PyTorch, written from
the problem's equations (Boyd et al., "Distributed Optimization and
Statistical Learning via the ADMM", sections 3.3 and 6.4; the examples
``lasso_example.m`` and ``total_variation.m``).  They import ``torch``,
``numpy`` and ``math`` only: nothing of the port, of its JAX reference or
of its tests.  They take the benchmark's inputs and derive every
factorisation themselves.
"""
