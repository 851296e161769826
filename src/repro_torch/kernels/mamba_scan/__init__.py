from .ops import MambaScanFunction, mamba_scan
from .ref import mamba_scan_chunked, mamba_scan_ref

__all__ = ["MambaScanFunction", "mamba_scan", "mamba_scan_chunked",
           "mamba_scan_ref"]
