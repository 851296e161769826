"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``run.py`` is the entry.  Everything a cell is made of is found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json``, ``runners/<runner>.py`` (named by the
traffic), ``metrics/<metric>.py`` and ``counts/<op>.py``.
The plain reference (``reference/``) and the document packer
(``docs.py``) import nothing of the port.
"""
