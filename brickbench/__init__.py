"""The benchmark of the PyTorch and CUDA port, ``bricklib_tpu_torch``.

``python -m brickbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the cards of this
machine and prints one JSON line.  Everything is found by name:

- ``configs/<config>.json``: a deployment (stencil, bricks, ghost depth,
  ST_ITER, its source, what was assumed and reduced);
- ``workloads/<traffic>.json``: a cell's traffic (configuration, domain
  a rank, fused depth, mesh, chips, the runs of steps and the check);
- ``stencils/<stencil>.py``: the frozen tap table the plain reference
  reads;
- ``metrics/<metric>.py``: one reader per metric of ``BENCHMARK.json``.

A new configuration, cell or metric is a new file and a new entry.  The
harness imports nothing of the JAX package; its reference imports
nothing of the port.
"""
