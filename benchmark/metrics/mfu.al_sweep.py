"""The AL sweep's share of the f32 peak: three reference forwards (the clean
pass and two MC passes) of every valid row at the padded widths, over a
call's mean seconds, in percent."""

from benchmark import readers


def read(facts: dict):
    return readers.sweep_mfu(facts, passes=3)
