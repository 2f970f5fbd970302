"""The train step's share of the f32 peak: the reference's forward, losses
and backward FLOPs per sample at B=16 and the padded widths, times the
samples trained, over the untraced epochs' train seconds, in percent."""

from benchmark import flops


def read(facts: dict):
    e = facts["entry"]
    ep = e["epochs"][1:] if "trace" in facts and len(e["epochs"]) > 1 else e["epochs"]
    if not ep:
        return None
    B = e["batch_size"]
    per_sample = flops.reference_flops(facts["spec"], B, e["W"], e["C"], train=True) / B
    return flops.peak_share("mfu.train", per_sample * e["samples"] * len(ep),
                            sum(x["train_s"] for x in ep))
