"""Percent of the traced span in which the device ran no kernel, copy or
fill (``idle_share.<cell>``)."""


def read(facts: dict):
    tr = facts.get("trace")
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
