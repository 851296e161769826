from .ops import MambaScanFunction, mamba_scan
from .ref import (carry_steps, mamba_scan_backward_ref, mamba_scan_chunked,
                  mamba_scan_ref)

__all__ = ["MambaScanFunction", "carry_steps", "mamba_scan",
           "mamba_scan_backward_ref", "mamba_scan_chunked", "mamba_scan_ref"]
