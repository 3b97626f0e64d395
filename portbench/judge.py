"""The comparison that decides ``correct``: what the timed solves returned
against the configuration's plain reference, run once the window has
closed on the same generated problem.

Five numbers, each the worst over the judged answers:

* ``chi2_report_gap``: |reported chi2 - f(x)| / f(x), f the reference's
  float64 cost at the answer's own state x: the solver says what its
  answer costs;
* ``cost_gap``: max(0, f(x) - f(x_ref)) / f(x_ref): the answer is as good
  as the reference's solve of the same problem from the same start;
* ``state_gap``: |x - x_ref| / |x_ref - x_start|, the answer's distance to
  the reference's solution over every variable (camera and pose tangents,
  landmark differences) as a share of how far that solution moved;
* ``worst_gap``: the largest distance of one variable from the
  reference's, as a share of the median distance a variable moved: one
  landmark or pose out of place;
* ``first_step_gap``: |c_1 - c_1,ref| / c_1,ref, c_1 the cost the solve
  reports after its first accepted LM step: a number steady from seed to
  seed, where those of the final state carry the rounding of every later
  step (PERF.md, section 6).

Each has the limit the configuration states, set from the readings in
PERF.md."""

from __future__ import annotations

import math

import torch

from .arith import Arith

NUMBERS = ("chi2_report_gap", "cost_gap", "state_gap", "worst_gap", "first_step_gap")


def reference_answer(ref, problem: dict, config: dict, arith: Arith) -> dict:
    """The reference's solve, and what the numbers compare against."""
    answer = ref.solve(problem, config, arith)
    f64 = Arith()
    answer["cost"] = ref.cost(problem, answer, f64)
    moved = ref.distances(answer, ref.start(problem))
    answer["moved"] = float(torch.linalg.vector_norm(moved))
    answer["moved_median"] = float(moved.median())
    return answer


def numbers(ref, problem: dict, answer: dict, against: dict) -> dict:
    f = ref.cost(problem, answer, Arith())
    gaps = ref.distances(answer, against)
    return dict(
        chi2_report_gap=abs(answer["chi2"] - f) / f,
        cost_gap=max(0.0, f - against["cost"]) / against["cost"],
        state_gap=float(torch.linalg.vector_norm(gaps)) / against["moved"],
        worst_gap=float(gaps.max()) / against["moved_median"],
        first_step_gap=abs(_value(answer["first_cost"]) - against["first_cost"]) / against["first_cost"],
    )


def _value(first_cost) -> float:
    """A float, or a function the answer left to read it after the window."""
    return float(first_cost() if callable(first_cost) else first_cost)


def verdict(worst: dict, limits: dict) -> bool:
    return all(math.isfinite(worst[k]) and worst[k] <= limits[k] for k in NUMBERS)


def worst_of(readings: list) -> dict:
    """Each number's worst over the answers; NaN where one is not a number
    (NaN fails every limit)."""
    out = {}
    for k in NUMBERS:
        vals = [r[k] for r in readings]
        out[k] = float("nan") if not vals or any(not math.isfinite(v) for v in vals) else max(vals)
    return out
