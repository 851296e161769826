"""Pluggable operator backends for the ETL component library.

``numpy`` is the always-available host reference; ``torch`` runs the same
operator kernels on a CUDA device (hand-written kernels in ``csrc/``) and
``torch_cpu`` is that backend pinned to the CPU.  See base.py for the
interface and selection order."""
from .base import (AGG_OPS, BACKEND_ENV_VAR, SEGMENT_KEEP_MASK, Backend,
                   available_backends, get_backend, get_default_backend,
                   register_backend, resolve_backend, set_default_backend)
from .numpy_backend import NumpyBackend

register_backend("numpy", NumpyBackend)


def _make_torch_backend() -> Backend:
    from .torch_backend import TorchBackend  # deferred: kernels load lazily
    return TorchBackend("cuda")


def _make_torch_cpu_backend() -> Backend:
    from .torch_backend import TorchBackend
    return TorchBackend("cpu")


register_backend("torch", _make_torch_backend)
register_backend("torch_cpu", _make_torch_cpu_backend)

__all__ = [
    "AGG_OPS", "BACKEND_ENV_VAR", "SEGMENT_KEEP_MASK", "Backend",
    "NumpyBackend",
    "available_backends", "get_backend", "get_default_backend",
    "register_backend", "resolve_backend", "set_default_backend",
]
