"""The benchmark harness of ``admm_tpu_torch``: cell discovery, the
closed-loop window, the profiler trace and its reduction, the roofline
arithmetic and the comparison that decides ``correct``.

Nothing here imports ``jax`` or ``admm_tpu``; the port is imported only
by the family modules under ``perfbench/families/``.
"""
