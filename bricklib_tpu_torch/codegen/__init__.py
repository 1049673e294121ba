from .pencil_kernel import (SweepPlan, pencil_stencil, pencil_sweep,
                            pencil_sweep_kernel, pencil_sweep_plain)
from .pencil_kernel_4d import (pencil_sweep_4d, pencil_sweep_4d_kernel,
                               pencil_sweep_4d_plain)

__all__ = ["SweepPlan", "pencil_stencil", "pencil_sweep",
           "pencil_sweep_kernel", "pencil_sweep_plain", "pencil_sweep_4d",
           "pencil_sweep_4d_kernel", "pencil_sweep_4d_plain"]
