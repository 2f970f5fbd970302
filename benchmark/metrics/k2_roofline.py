"""K2's product FLOPs at the sweep's (B, T, W, D) over 67 TFLOP/s, as a
percentage of its mean launch time in the trace (``k2_roofline.<cell>``);
nothing without a launch."""

from benchmark import flops
from benchmark import trace as tracing


def read(facts: dict):
    e, tr = facts["entry"], facts.get("trace")
    times = tracing.kernel_times(tr, "fused_forward_kernel") if tr else []
    if not times:
        return None
    work = flops.k2_flops(e["batch_size"], e["T"], e["W"], e["D"], e["attn_layer"])
    return flops.peak_share("k2_roofline", work, sum(times) / len(times))
