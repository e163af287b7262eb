"""Job kinds. A traffic file names its kind under ``job``; the kind's
module holds ``Job(config, mix, seed, device)`` with ``warm()``,
``step(i, run)``, ``release()`` and ``check()``. ``check`` returns the
numbers compared, each as (name, value, limit): the run is correct when
every value is finite and at most its limit."""
