"""Where a solve runs: the one placement rule of the port's entry points.

The port is written for the card, so a solve goes to the CUDA device
unless the caller says otherwise, either with ``device=`` or by handing
over tensors that already lie somewhere (a tensor on the CPU is the
caller asking for the CPU).  There is no silent fallback: without a
visible CUDA device the default raises and names ``device="cpu"``.
"""

from __future__ import annotations

import torch


def _tensors(*objs):
    """The tensors among ``objs``, dict values included, in order."""
    for o in objs:
        if isinstance(o, dict):
            yield from _tensors(*o.values())
        elif isinstance(o, torch.Tensor):
            yield o


def resolve_device(device, *operands) -> torch.device:
    """The device of a solve, in this order: ``device`` when given; else
    that of the first tensor among ``operands`` (dict values included);
    else ``torch.device("cuda")``, which raises ``RuntimeError`` when no
    CUDA device is visible."""
    if device is not None:
        return torch.device(device)
    found = next(_tensors(*operands), None)
    if found is not None:
        return found.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "admm_tpu_torch solves on the CUDA device by default, and none is "
            "visible; pass device=\"cpu\" (or tensors on the CPU) to solve on "
            "the CPU")
    return torch.device("cuda")
