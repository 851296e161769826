# Hand-written CUDA kernels (sm_90a) for the port's hot spots, one package
# per TPU kernel of the reference:
#
#   hash_join       — open-addressing hash build (host), the table packed
#                     on the device, and the CUDA probe for the Lookup
#                     component (csrc/hash_probe.cu).
#   radix_groupby   — deterministic grouped sums + counts over
#                     dense key ids for keyed Aggregates
#                     (csrc/radix_groupby.cu).
#   segment_sum     — the same reduction without counts, for global
#                     aggregates and the sort-route fallback
#                     (csrc/segment_sum.cu).
#   flash_attention — GQA attention with an online softmax for the dense
#                     models' prefill: bf16 on the tensor cores
#                     (csrc/flash_attention_mma.cu), fp32 in FMAs
#                     (csrc/flash_attention.cu); its gradient for training
#                     (csrc/flash_attention_bwd.cu).
#   mamba_scan      — the Mamba-1 selective scan for the SSM models' prefill
#                     (csrc/mamba_scan.cu) and its gradient for training
#                     (csrc/mamba_scan_bwd.cu).
#   adamw           — no TPU kernel: the optimizer's update and the
#                     gradients' global norm, each one pass over the
#                     state (csrc/adamw.cu); the plain route is
#                     train/optimizer.py's.
#
# Each package has ops.py (the wrapper: the kernel on a CUDA tensor, the
# plain version on a CPU tensor, a launch counter) and ref.py (the plain
# torch version the CPU tests and chip_smoke.py hold the kernel against).
# _cuda.py builds csrc/*.cu with nvcc at first use and counts launches (the
# grouped sums' also by route).
from ._cuda import (KernelLibraryError, launch_counts, reset_launches,
                    route_counts)

__all__ = ["KernelLibraryError", "launch_counts", "reset_launches",
           "route_counts"]
