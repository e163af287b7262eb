"""Ms per plan check inside the port's mia.dose.goals span
(evaluate_constraints) in which the device ran nothing: the dose
model's host work (program span on the device trace's clock)."""

from harness import spans


def read(run):
    return spans.per_job(run, spans.idle_s(run.trace, "mia.dose.goals"), 1e3)
