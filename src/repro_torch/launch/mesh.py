"""Meshes of the port: ``torch.distributed`` device meshes in place of the
JAX package's ``jax.sharding.Mesh`` (``repro.launch.mesh``).

The production meshes keep the reference's topology, so that placements
can be held against the JAX package's leaf by leaf:

  single pod: (data=16, model=16) = 256 ranks;
  multi-pod:  (pod=2, data=16, model=16) = 512 ranks; ``pod`` is an outer
              data-parallel axis (batches shard over ("pod", "data")).

torch runs one process per device (SPMD), so a ``DeviceMesh`` needs a
process group of its size: ``process_group`` brings one up (NCCL on CUDA,
gloo on the CPU, torch's ``fake`` group for the dry-run, where one process
stands for every rank and tensors live on ``meta``) and tears it down on
the way out.  Nothing here touches process-group state at import.

``MeshShape`` is a mesh's shape and axis names with no process group
behind it, JAX's ``AbstractMesh``: the placement rules
(``launch/partition.py``) read only these, so a test computes the
production meshes' specs without 512 ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile

import torch
import torch.distributed as dist

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's shape and axis names, as ``DeviceMesh`` exposes them
    (``shape``, ``mesh_dim_names``), with no devices behind it."""
    shape: tuple
    mesh_dim_names: tuple


def _make_mesh(shape, names, device_type: str | None):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs a process group: run inside "
                           "launch.mesh.process_group(...)")
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} ranks, "
                         f"the process group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """The reference topology: (16, 16) ("data", "model"), or (2, 16, 16)
    ("pod", "data", "model") with ``multi_pod``, over a process group of
    256 or 512 ranks (the dry-run's fake group)."""
    shape, names = PRODUCTION[multi_pod]
    return _make_mesh(shape, names, device_type)


def make_serving_mesh(*, data: int | None = None, model: int = 1,
                      device_type: str | None = None):
    """Serving mesh: the decode slot pool shards over ``data``, params go
    tensor-parallel over ``model``.  ``data`` defaults to the process
    group's ranks // model, so one rank gives the degenerate (1, 1) mesh."""
    if data is None:
        data = max(1, dist.get_world_size() // model)
    return _make_mesh((data, model), ("data", "model"), device_type)


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def data_axes(mesh) -> tuple[str, ...]:
    """The batch-sharding axes of a mesh from make_production_mesh."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"


def axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    sizes = axis_sizes(mesh)
    size = 1
    for n in names:
        size *= sizes[n]
    return size


@contextlib.contextmanager
def process_group(backend: str, *, world_size: int = 1, rank: int = 0,
                  init_method: str | None = None):
    """Bring up the default process group for the block, and destroy it
    on the way out.

    backend: "nccl" (one CUDA device a rank: rank r takes device r), "gloo"
    (CPU ranks) or "fake" (the dry-run: this process is rank ``rank`` of a
    ``world_size`` group whose collectives move nothing).  init_method: a
    ``file://`` rendezvous the ranks share (a fresh one under the system's
    temporary directory when a single rank runs alone); multi-rank gloo and
    NCCL need one.  No TCP port is ever fixed, so parallel runs never
    collide."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already up in this process")
    owned = None
    kw = {}
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore

        kw["store"] = FakeStore()
    else:
        if init_method is None:
            if world_size != 1:
                raise ValueError(f"{world_size} {backend} ranks need a shared "
                                 "init_method (file://...)")
            fd, owned = tempfile.mkstemp(prefix="repro_torch_pg_")
            os.close(fd)
            os.unlink(owned)
            init_method = f"file://{owned}"
        kw["init_method"] = init_method
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if owned is not None and os.path.exists(owned):
            os.unlink(owned)
