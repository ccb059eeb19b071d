"""One file a per-layer metric, ``<metric>.py``, whose ``read(reader) ->
float | None`` computes it (the arithmetic is in ``portbench/readers.py``):
None where the run holds nothing to read (the metric is then left out of the
result); never 0 for a share of a roofline or a peak."""
