"""Milliseconds a train step: the port's ``last_epoch_wall`` train seconds
(host clock from an epoch's start to its one fetch) over its steps, summed
over the window's untraced epochs."""


def _epochs(facts: dict) -> list:
    ep = facts["entry"]["epochs"]
    return ep[1:] if "trace" in facts and len(ep) > 1 else ep


def read(facts: dict):
    ep = _epochs(facts)
    if not ep:
        return None
    return 1e3 * sum(e["train_s"] for e in ep) / sum(e["steps"] for e in ep)
