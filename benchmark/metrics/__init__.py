"""One reader a per-layer metric, ``<metric>.py``, found by the metric's
name in ``BENCHMARK.json``. A reader has ``read(ctx) -> float | None``
(None where it finds nothing to read; the run then leaves the metric out)
and may have ``install(ctx)`` and ``uninstall(ctx)``, called around the
traced window. ``ctx`` is ``run.Context``: the cell, the window's steps,
the trace's plain lists (``trace.py``) and the device operations the
program launched in the window."""
