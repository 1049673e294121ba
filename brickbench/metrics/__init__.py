"""One reader per metric of ``BENCHMARK.json``, found by its name.

A reader module states ``UNIT``, ``BETTER`` and ``SOURCE`` (and for a
per-layer metric ``LAYER`` and ``MOVES``) as ``BENCHMARK.json`` gives
them, and ``read(record)``: the metric's value from a
:class:`brickbench.harness.Record`, or None where the run has nothing
for it to read (the harness then leaves the metric out).
"""
