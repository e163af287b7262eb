"""Device ms per registration of the copies (Memcpy, both ways) launched
under the benchmark's own bench.* spans around its calls into the port
(device trace); the port's mia.* spans split them in PERF.md."""

from harness import spans


def read(run):
    return spans.per_job(run, spans.copy_s(run.trace), 1e3)
