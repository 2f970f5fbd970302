"""Seconds from the process's start to the window's: imports, inputs made
from the seed, the Trainer, the kernel builds or loads, the warm-up."""


def read(facts: dict) -> float:
    return facts["setup_s"]
