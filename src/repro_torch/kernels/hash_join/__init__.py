from .ops import hash_probe
from .ref import hash_build, hash_keys, hash_keys_np, hash_probe_ref

__all__ = ["hash_build", "hash_keys", "hash_keys_np", "hash_probe",
           "hash_probe_ref"]
