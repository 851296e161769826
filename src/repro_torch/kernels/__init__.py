# Hand-written CUDA kernels (sm_90a) for the port's hot spots, one package
# per TPU kernel of the reference:
#
#   hash_join       — open-addressing hash build (host) + CUDA probe for the
#                     Lookup component (csrc/hash_probe.cu).
#   radix_groupby   — deterministic partitioned grouped sums + counts over
#                     dense key ids for keyed Aggregates
#                     (csrc/radix_groupby.cu).
#   segment_sum     — the same reduction without counts, for global
#                     aggregates and the sort-route fallback
#                     (csrc/segment_sum.cu).
#
# Each package has ops.py (the wrapper: the kernel on a CUDA tensor, the
# plain version on a CPU tensor, a launch counter) and ref.py (the plain
# torch version the CPU tests and chip_smoke.py hold the kernel against).
# _cuda.py builds csrc/*.cu with nvcc at first use and counts launches.
from ._cuda import launch_counts, reset_launches

__all__ = ["launch_counts", "reset_launches"]
