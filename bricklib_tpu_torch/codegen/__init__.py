from .pencil_kernel import (SweepPlan, pencil_stencil, pencil_sweep,
                            pencil_sweep_kernel, pencil_sweep_plain)

__all__ = ["SweepPlan", "pencil_stencil", "pencil_sweep",
           "pencil_sweep_kernel", "pencil_sweep_plain"]
