"""Percent of an epoch's wall time spent in its test sweep (the port's
``last_epoch_wall``: eval seconds over train plus eval seconds), over the
window's untraced epochs."""


def read(facts: dict):
    ep = facts["entry"]["epochs"]
    ep = ep[1:] if "trace" in facts and len(ep) > 1 else ep
    if not ep:
        return None
    return 100.0 * sum(e["eval_s"] for e in ep) / sum(e["train_s"] + e["eval_s"] for e in ep)
