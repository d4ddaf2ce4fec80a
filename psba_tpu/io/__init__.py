"""Problem I/O: SBA text formats, BAL conversion, synthetic generation."""

from psba_tpu.io.sba_text import load_problem, read_cams, read_pts
from psba_tpu.io.bal import read_bal, bal_to_problem
from psba_tpu.io.synthetic import (
    bal_shaped_problem,
    synthesize_points_for_cams,
    synthetic_problem,
)

__all__ = [
    "load_problem",
    "read_cams",
    "read_pts",
    "read_bal",
    "bal_to_problem",
    "bal_shaped_problem",
    "synthesize_points_for_cams",
    "synthetic_problem",
]
