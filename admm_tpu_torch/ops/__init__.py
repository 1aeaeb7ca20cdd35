"""Operator building blocks: proxes, linear solves and GPU kernels."""
