from .ops import PackedTable, hash_probe, hash_probe_cuda, pack_table
from .ref import (SLOT_WORDS, hash_build, hash_keys, hash_keys_np,
                  hash_probe_packed_ref, hash_probe_ref, pack_slots)

__all__ = ["PackedTable", "SLOT_WORDS", "hash_build", "hash_keys",
           "hash_keys_np", "hash_probe", "hash_probe_cuda",
           "hash_probe_packed_ref", "hash_probe_ref", "pack_slots",
           "pack_table"]
