"""Named-column tabular output — the GLF format.

Mirrors OutputData (OutputData.hpp:32-116) and the GLF schema from
Parameters::makeGLFOutputData (DInDel.hpp:262-276).  Unset columns print as
``NA``; floats print with C++ ``operator<<`` default formatting (6
significant digits) so outputs are textually identical to the reference.
"""

from __future__ import annotations

from typing import Dict, List, TextIO

from .utils import fmt_g

GLF_COLUMNS: List[str] = [
    "msg", "index", "analysis_type",
    "tid", "lpos", "rpos", "center_position", "realigned_position",
    "was_candidate_in_window",
    "ref_all", "nref_all", "num_reads",
    "post_prob_variant", "qual", "est_freq", "logZ", "hapfreqs",
    "indidx", "msq", "numOffAll", "num_indel",
    "num_cover_forward", "num_cover_reverse", "num_unmapped_realigned",
    "var_coverage_forward", "var_coverage_reverse",
    "nBQT", "nmmBQT", "mLogBQ", "nMMLeft", "nMMRight",
    "glf",
]

class OutputData:
    """Column registry + writer (OutputData.hpp:32-116)."""

    def __init__(self, out: TextIO, columns: List[str]):
        self.out = out
        self.columns = list(columns)
        self.label_to_column: Dict[str, int] = {c: i for i, c in enumerate(columns)}
        if len(self.label_to_column) != len(columns):
            raise ValueError("Duplicate label")
        self.num_lines = 0

    def header_string(self) -> str:
        return " ".join(self.columns)

    def write_header(self) -> None:
        self.out.write(self.header_string() + "\n")

    def line(self) -> "Line":
        return Line(self)

    def output(self, line: "Line") -> None:
        self.num_lines += 1
        self.out.write(line.to_string() + "\n")


class Line:
    """One output row with NA defaults (OutputData.hpp:65-102); a note,
    where set, follows the columns after ' #' (the benchmark's own
    remark on the row, not a GLF column)."""

    def __init__(self, od: OutputData):
        self._od = od
        self.data = ["NA"] * len(od.columns)
        self.note = ""

    def set(self, label: str, value) -> "Line":
        idx = self._od.label_to_column.get(label)
        if idx is None:
            raise KeyError(f"Column label {label} not found!")
        self.data[idx] = fmt_g(value)
        return self

    def get(self, label: str) -> str:
        idx = self._od.label_to_column.get(label)
        if idx is None:
            raise KeyError(f"Column label {label} not found!")
        return self.data[idx]

    def copy(self) -> "Line":
        ln = Line(self._od)
        ln.data = list(self.data)
        ln.note = self.note
        return ln

    def to_string(self) -> str:
        text = " ".join(self.data)
        return text + " #" + self.note if self.note else text


def make_glf_output(out: TextIO) -> OutputData:
    od = OutputData(out, GLF_COLUMNS)
    return od
