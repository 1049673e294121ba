"""The stencil corpus and its coefficients, reused from the reference
(``bricklib_tpu/stencils``: pure-Python eDSL modules, no JAX)."""

from bricklib_tpu.stencils import (CORPUS, DEFAULT_PARAMS, bench_params,
                                   stencil_by_name)

__all__ = ["CORPUS", "DEFAULT_PARAMS", "bench_params", "stencil_by_name"]
