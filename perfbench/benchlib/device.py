"""What the run says about its card: name, count, memory peak, and the
clocks and power that ``nvidia-smi`` reads (it sets nothing)."""

from __future__ import annotations

import subprocess

QUERY = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"


def smi(index: int = 0) -> str:
    """``nvidia-smi``'s reading of the card, or why there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={QUERY}", "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi not read ({type(exc).__name__})"
    if out.returncode != 0:
        return f"nvidia-smi exit {out.returncode}"
    return f"{QUERY}: {out.stdout.strip()}"


def describe(device, chips: int) -> dict:
    """The result line's ``device`` object for the chips the cell uses."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
