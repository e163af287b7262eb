"""The mean card's busy share of the traced window, in %: the device
activities' time summed over every card (each clipped to the window) over
the cohort's four cards times the window (device trace). The cards' union
is the ledger's busy share; this is their mean."""

CARDS = 4                  # the cohort cell's chips, one data row a card


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    busy_ns = sum(e - s for s, e in run.trace.clipped())
    return 100.0 * busy_ns * 1e-9 / (CARDS * run.trace.window_s)
