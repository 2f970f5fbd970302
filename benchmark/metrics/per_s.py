"""The reader of every end-to-end rate named ``<work>_per_s`` that has no
reader of its own: the work completed in the window over the window's
seconds (host clock)."""


def read(facts: dict) -> float:
    return sum(facts["units"]) / facts["window_s"]
