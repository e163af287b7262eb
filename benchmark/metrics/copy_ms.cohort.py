"""Device ms per step of the cohort of the copies (Memcpy, both ways, on
every card) launched under the benchmark's own bench.* span around its
demons_batch call (device trace)."""

from harness import spans


def read(run):
    return spans.per_job(run, spans.copy_s(run.trace), 1e3)
