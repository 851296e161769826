from .ops import mamba_scan
from .ref import mamba_scan_ref

__all__ = ["mamba_scan", "mamba_scan_ref"]
