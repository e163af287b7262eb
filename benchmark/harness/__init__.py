"""The benchmark of the PyTorch / CUDA port (medicalimageanalysis_torch).

``benchmark/run.py`` runs one cell of ``BENCHMARK.json`` once. Everything
that belongs to one configuration, traffic mix or per-layer metric sits in
a file of its own, found by name:

- ``benchmark/configs/<config>.json``: a deployment's sizes;
- ``benchmark/workloads/<traffic>.json``: a traffic mix, the parameters
  one job kind (``harness/jobs/<job>.py``) reads;
- ``benchmark/metrics/<metric>.py``: a reader ``read(run)`` that returns
  the metric's value, or None when the run holds nothing to read;
- ``benchmark/limits/<cell>.json``: the limit of each number the cell's
  correctness check compares;
- ``benchmark/held_out/<cell>.json``: the manifest entries of a cell kept
  out of ``BENCHMARK.json``, whose job kind the tests still run.

Nothing here imports JAX or the JAX package; the plain references under
``harness/reference`` import nothing of the port either.
"""
