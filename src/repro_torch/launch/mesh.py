"""Device meshes over ``torch.distributed`` (``repro/launch/mesh.py``).

``make_host_mesh`` is ``init_device_mesh`` over the process group the
caller initialised (``torchrun`` and ``init_distributed``, or a test's
spawned ranks), named ``("data", "model")`` or ``("data",)``.
``make_production_mesh`` keeps only the production meshes' shapes and
names: the sharding specs are computed from them without 256 processes.
``make_fake_mesh`` / ``make_fake_production_mesh`` build a real
``DeviceMesh`` at the production world size over torch's fake process
group, on which ``launch/dryrun.py`` traces a step on meta tensors.
The reference's TPU v5e roofline constants are not carried over: the H100
figures live in ``launch/roofline.py``, ``chip_smoke.py`` and PERF.md.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


class MeshShape:
    """A mesh's axis names and sizes, with no devices: ``.shape`` maps
    axis -> size as the reference's ``Mesh.shape`` does."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod (shapes and
    names only)."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_fake_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]
                   ) -> DeviceMesh:
    """A ``DeviceMesh`` of ``prod(shape)`` ranks of torch's fake process
    group (``torch.testing._internal.distributed.fake_pg``, an internal
    module imported here only): this process is rank 0 and no other rank
    exists; every collective returns at once without moving data. For
    DTensors over meta tensors (``launch/dryrun.py``). The mesh is built
    as a 'cpu' one (a 'cuda' one would claim a card) and then named a
    'cuda' one: DTensor chooses some collectives by the name, and on a
    'cpu' mesh it replaces each all-to-all by an all-gather (gloo has no
    all-to-all), which the card's NCCL ranks would not run. Refuses to
    start when a real process group is initialised; a fake one of another
    world size is replaced."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = 1
    for s in shape:
        n *= s
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"make_fake_mesh: a {dist.get_backend()!r} process group is "
                f"initialised; the fake group is process-global, so trace in "
                f"a process of its own")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))
    mesh._device_type = "cuda"
    return mesh


def make_fake_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """``make_production_mesh``'s shape as a ``make_fake_mesh``: world 256,
    ("data", "model") 16x16; multi-pod world 512, ("pod", "data",
    "model") 2x16x16."""
    m = make_production_mesh(multi_pod=multi_pod)
    return make_fake_mesh(tuple(m.shape.values()), m.axis_names)


def init_distributed(backend: Optional[str] = None,
                     device: str = "cuda") -> str:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``; a world of 1 without
    them) unless one exists.  ``backend``: ``nccl`` on the card and
    ``gloo`` on the CPU by default; another only when named.  Under
    ``nccl`` a world larger than the visible cards raises: NCCL puts no
    two ranks on one card, and nothing switches to gloo behind the
    caller's back.  Returns the backend in use."""
    if dist.is_initialized():
        return dist.get_backend()
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA card; pass "
                               "device='cpu' for gloo on the CPU")
        cards = torch.cuda.device_count()
        if backend == "nccl" and world > cards:
            raise RuntimeError(
                f"init_distributed: a world of {world} ranks under nccl "
                f"needs {world} cards, {cards} visible (NCCL puts no two "
                f"ranks on one card); name --dist-backend gloo to run "
                f"them on fewer cards")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % cards)
    if "MASTER_ADDR" not in os.environ:
        if world != 1:
            raise RuntimeError("init_distributed: WORLD_SIZE > 1 without "
                               "MASTER_ADDR (run under torchrun)")
        os.environ["MASTER_ADDR"] = "localhost"
        os.environ.setdefault("MASTER_PORT", str(_free_port()))
    dist.init_process_group(backend, rank=rank, world_size=world)
    return backend


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_host_mesh(data: int = 1, model: Optional[int] = 1,
                   device: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the initialised process group (the first
    data * model ranks); ``model=None`` builds the data-only 1-axis
    ``(data,)`` mesh.  ``device``: the card (default) or 'cpu'."""
    if model is None:
        shape, axes = (data,), ("data",)
    else:
        shape, axes = (data, model), ("data", "model")
    return make_mesh(shape, axes, device)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: str = "cuda") -> DeviceMesh:
    """A mesh of any shape and axis names over the process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "launch.mesh.init_distributed first")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"need {n} devices, have {world}")
    dev_type = torch.device(device).type
    if n == world:
        return init_device_mesh(dev_type, tuple(shape),
                                mesh_dim_names=tuple(axes))
    ranks = torch.arange(n).reshape(tuple(shape))
    return DeviceMesh(dev_type, ranks, mesh_dim_names=tuple(axes))


def parse_mesh(text: str) -> Dict[str, int]:
    """'data=2,model=2' (and 'pod=P') -> {'data': 2, 'model': 2}, in the
    mesh order pod, data, model."""
    sizes = {}
    for part in text.split(","):
        name, _, n = part.partition("=")
        name = name.strip()
        if name not in ("pod", "data", "model") or not n.strip().isdigit():
            raise ValueError(f"--mesh: bad entry {part!r} (want pod=P, "
                             f"data=D, model=M)")
        sizes[name] = int(n)
    return {k: sizes[k] for k in ("pod", "data", "model") if k in sizes}
