"""K4, ``csrc/cr_solve.cu``: the TV x-update's tridiagonal solve, its
least time over the device time of its kernel in the engine loops, in %.
Least time: ``roofline.tridiagonal_solve`` (three diagonals, the
right-hand side and the solution, once each) for the steps each solve
needed, whatever elimination the kernel runs."""

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "ops.tridiag: K4"
MOVES = "iter_per_s"
WORKLOADS = ["tv1d_65536.solve"]
KERNEL_PATTERNS = [r"cr_tile"]


def read(run):
    return run.roofline("k4_roofline", KERNEL_PATTERNS, "k4")
