"""Per-layer metric readers, one module per metric of ``BENCHMARK.json``
(the file is named after the metric). Each has ``read(m)``, where ``m``
is the traced window's ``harness.core.Measure``, and returns a number,
or None when it finds nothing to read (the metric is then left out)."""
