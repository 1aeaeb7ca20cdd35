"""The LASSO x-update's GEMV pair (a GEMM pair over a path's lanes):
its least time over its device time in the engine loops, in %.

Least time: ``roofline.fat_lasso_xupdate`` (D and an m x m factor read
once a step from HBM) for the steps each instance needed, plus the one
product D x of the objective each solve ends with; device time: the
kernels in the loops whose names match ``KERNEL_PATTERNS`` (cuBLAS's
GEMV, GEMM and split-K kernels, or the port's K2)."""

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "ops.solve: x-update GEMV pair"
MOVES = "iter_per_s"
WORKLOADS = ["lasso_boyd_1500x5000.solve", "lasso_boyd_1500x5000.path100"]
KERNEL_PATTERNS = [r"gemv", r"gemm", r"splitKreduce", r"xmma", r"cutlass", r"sgemm"]


def read(run):
    return run.roofline("xupdate_roofline", KERNEL_PATTERNS, "xupdate", extra=("once",))
