"""Batched cohort pipelines and multi-device execution: ``batch`` (the
cohort functions, each with a ``mesh=`` path over the 'data' axis),
``mesh`` (the (data, space) device mesh, its shardings and collectives),
``halo`` (volumes sharded along z with halo exchange) and ``cohort``
(cohort ingest, the multi-process global batch)."""
