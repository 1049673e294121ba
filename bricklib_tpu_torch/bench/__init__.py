from .roofline import (barrier, chain, copy_storage, copy_storage_plain,
                       make_dma_copy)
from .timing import mpi_statistics, time_mpi

__all__ = ["barrier", "chain", "copy_storage", "copy_storage_plain",
           "make_dma_copy", "mpi_statistics", "time_mpi"]
