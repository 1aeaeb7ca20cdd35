"""Randomized correctness/scaling test harness (port of
``admm_tpu/testers``).

The analog of the reference's testers/ directory (SURVEY.md
sections 2.5, 4): per-problem randomized oracle testers with the
reference signature ``<name>test(seed, rows, cols, errtol, quiet,
options)`` returning (results, test) with pass/fail + reason, plus the
multi-scale batch harness ``solvertester`` (testers/solvertester.m:29).
"""

from .problems import (
    make_svm_instance,
    basispursuittest,
    covarianceselectiontest,
    huberfittest,
    ladtest,
    lassotest,
    linearprogramtest,
    logregtest,
    linearsvmtest,
    modeltest,
    quadraticprogramtest,
    totalvariationtest,
)
from .solvertester import solvertester

__all__ = [
    "make_svm_instance",
    "solvertester",
    "modeltest",
    "lassotest",
    "basispursuittest",
    "totalvariationtest",
    "ladtest",
    "huberfittest",
    "linearprogramtest",
    "logregtest",
    "quadraticprogramtest",
    "covarianceselectiontest",
    "linearsvmtest",
]
