"""Compute kernels of the port: the segment-reduce dispatch with its
hand-written Hopper kernel, and the FedAvg reduce, flash-attention and
SSD-scan kernels (``ops``)."""
from repro_torch.kernels.segment_reduce import (BACKENDS, resolve_backend,
                                                segment_count, segment_max,
                                                segment_median, segment_min,
                                                segment_reduce, segment_std)

__all__ = ["BACKENDS", "resolve_backend", "segment_count", "segment_max",
           "segment_median", "segment_min", "segment_reduce", "segment_std"]
