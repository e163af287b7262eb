"""From process start to the first timed job: imports, kernel load, inputs
on the card, one warm job (host clock)."""


def read(run):
    return run.setup_s
