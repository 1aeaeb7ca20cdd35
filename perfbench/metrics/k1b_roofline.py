"""K1b, the tail mode of ``csrc/zu_tail.cu``: the LASSO z/u pass and
step tail's least time over the device time of its kernel in the engine
loops, in %.  Least time: ``roofline.soft_threshold_tail`` for the steps
each solve needed."""

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "ops.kernels: K1b"
MOVES = "iter_per_s"
WORKLOADS = ["lasso_boyd_1500x5000.solve"]
KERNEL_PATTERNS = [r"zu_tail"]


def read(run):
    return run.roofline("k1b_roofline", KERNEL_PATTERNS, "k1b")
