"""bricklib_tpu_torch — the bricked-stencil framework on PyTorch and CUDA.

A port of ``bricklib_tpu`` (JAX on a TPU) to one NVIDIA H100.  The JAX
package stays the reference: this package reuses its pure-Python,
numpy-only modules (the stencil eDSL, the corpus, the IR, the evaluator,
the decomposition planner, the layout helpers) by import, never imports
``jax``, and keeps the reference's module names so each counterpart is
easy to find:

- ``codegen.pencil_kernel`` — the fused pencil sweep, kernel K1;
- ``comm.exchange``         — the one-device SHIFT exchange, kernel K2;
- ``bench.roofline``        — the copy roofline, kernel K3, and timing;
- ``bench.timing``          — the reference's timing protocol;
- ``drivers.weak``          — the weak-scaling step end to end;
- ``core``, ``convert``     — storage helpers and state carried over from
                              the reference;
- ``_build``                — builds ``csrc/*.cu`` with nvcc on first use.

A CPU tensor runs each kernel's plain PyTorch version; a CUDA tensor
launches the kernel or raises.  Nothing falls back to the CPU by itself.
"""

__version__ = "0.1.0"
