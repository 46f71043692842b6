"""Small numeric helpers shared across the framework.

Reference: Utils.hpp:29-47 (addLogs), StringHash.hpp.
"""

from __future__ import annotations

import math

LOGTINY = -100.0  # ObservationModelFB.hpp:24
EPS = 1e-10       # ObservationModelFB.hpp:25


def add_logs(l1: float, l2: float) -> float:
    """log(exp(l1)+exp(l2)), evaluated like the reference (Utils.hpp:29).

    The reference form keeps the larger argument outside the exp, so results
    are bit-comparable with the C++ implementation.
    """
    if l1 > l2:
        return l1 + math.log(1.0 + math.exp(l2 - l1))
    return l2 + math.log(1.0 + math.exp(l1 - l2))


def fmt_g(x) -> str:
    """Format a number the way C++ ``ostream<<double`` does (6 significant
    digits, %g semantics) so text outputs match the reference byte-for-byte."""
    if isinstance(x, bool):
        return "1" if x else "0"
    if isinstance(x, int):
        return str(x)
    if isinstance(x, float):
        if x != x:  # nan; glibc prints the sign bit ("-nan" for 0.0/0.0)
            import math
            return "-nan" if math.copysign(1.0, x) < 0 else "nan"
        if x == float("inf"):
            return "inf"
        if x == float("-inf"):
            return "-inf"
        if x == int(x) and abs(x) < 1e15:
            # C++ prints integral doubles without decimal point under %g
            return "%g" % x
        return "%g" % x
    return str(x)


def phred_prob(phred: float) -> float:
    """Convert a phred score to a probability of being correct, clamped to
    [1e-16, 1-1e-16] like Read.hpp:128-147."""
    q = 1.0 - math.pow(10.0, -phred / 10.0)
    if q < 1e-16:
        q = 1e-16
    if q > 1.0 - 1e-16:
        q = 1.0 - 1e-16
    return q
