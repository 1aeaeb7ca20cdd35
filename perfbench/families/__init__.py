"""Problem families: for each, its seeded instance pool, its request
stream, the port's entries the window drives, the controls, the call to
its plain reference and the least-time arithmetic of its layers.

A family module provides ``make_pool``, ``requests``, ``port``,
``controls``, ``reference`` and ``layer_cost``; the harness finds it by
the ``family`` key of a configuration's file.
"""
