"""LNCC windowed sums per registration, from the port's counter
ops/registration/demons.SYN (box_sums) as the job read it around each
registration of the window; five an iteration (program counter). A port
without the counter reads nothing."""


def read(run):
    syn = getattr(run, "syn", None)
    if not syn or not run.jobs:
        return None
    return syn["box_sums"] / len(run.jobs)
