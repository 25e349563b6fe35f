"""The MMD pair-sum kernels' share of their roofline, in percent: the
least time of the forward and both gradients of the unbiased MMD^2 at the
cell's feature shapes (benchmark.flops.mmd2_bound_ms) over the CUDA-event
time of the port's mmd2_objective forward and backward there."""

from benchmark.flops import mmd2_bound_ms


def read(run):
    m = run.get("mmd")
    if not m or not m.get("ms"):
        return None
    return 100.0 * mmd2_bound_ms(m["rows"], m["dof"], m["kernel"], m["alphas"]) / m["ms"]
