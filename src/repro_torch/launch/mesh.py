"""Meshes on ``torch.distributed`` (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names, ``("data", "model")`` or ``("pod", "data",
"model")``, over the world of ranks — one process a rank, as ``torchrun``
starts them.  Importing this module touches no process group; the world is
joined inside the functions:

  * under ``torchrun`` (``MASTER_ADDR`` and ``WORLD_SIZE`` in the
    environment), from the environment;
  * for a world of one with no launcher, on a free ``localhost`` port;
  * else the caller initializes it (``torch.distributed
    .init_process_group`` with its address, world size and rank) first.

The collective backend is a property of the mesh (:func:`mesh_backend`):
NCCL where each rank has its own card, and for a world of one on the card;
gloo on the CPU, and for several ranks sharing one card, which NCCL
refuses ("Duplicate GPU detected").  Each function raises where the world
size differs from the mesh's size.
"""
from __future__ import annotations

import math
import os
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist

AXES_2D = ("data", "model")
AXES_3D = ("pod", "data", "model")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def default_backend(device: str, world: int) -> str:
    """NCCL on CUDA with a card a rank; gloo on the CPU or with ranks
    sharing a card."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def _join_world(size: int, device: str, backend: Optional[str]) -> None:
    """Join the process group for a mesh of ``size`` ranks, unless the
    caller already has."""
    if dist.is_initialized():
        if backend is not None and dist.get_backend() != backend:
            raise ValueError(f"the process group runs "
                             f"{dist.get_backend()!r}, not {backend!r}")
        return
    env = "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ
    world = int(os.environ["WORLD_SIZE"]) if env else 1
    if not env and size != 1:
        raise RuntimeError(
            f"a mesh of {size} ranks needs the process group: run under "
            f"torchrun, or call torch.distributed.init_process_group first")
    backend = backend or default_backend(device, world)
    kw = {}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    if env:
        dist.init_process_group(backend, **kw)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}", rank=0,
            world_size=1, **kw)


def make_mesh(shape: Tuple[int, ...], axes: Optional[Tuple[str, ...]] = None,
              *, device: str = "cuda", backend: Optional[str] = None):
    """A mesh of ``shape`` over the world, e.g. ``make_mesh((2, 2))``;
    ``axes`` default to ``("data", "model")`` for two dims and the trailing
    names of ``("pod", "data", "model")`` otherwise.  ``device``: the
    device type the ranks compute on; ``backend``: the process group's,
    when this call starts it (default :func:`default_backend`)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(int(s) for s in shape)
    if axes is None:
        axes = AXES_2D if len(shape) == 2 else AXES_3D[-len(shape):]
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    size = math.prod(shape)
    _join_world(size, device, backend)
    if dist.get_world_size() != size:
        raise ValueError(f"mesh {shape} needs {size} ranks; the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=tuple(axes))


def single_device_mesh(*, device: str = "cuda",
                       backend: Optional[str] = None):
    """A (1, 1) ``("data", "model")`` mesh: a world of one."""
    return make_mesh((1, 1), device=device, backend=backend)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda",
                         backend: Optional[str] = None):
    """The reference's production shapes: (data=16, model=16), 256 ranks;
    multi-pod (pod=2, data=16, model=16), 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_mesh(shape, device=device, backend=backend)


def mesh_backend(mesh) -> str:
    """The collective backend a mesh's groups run."""
    return dist.get_backend(mesh.get_group(mesh.mesh_dim_names[0]))


def parse_mesh(text: str) -> Tuple[int, ...]:
    """``"2x2"`` -> (2, 2)."""
    try:
        shape = tuple(int(s) for s in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected DxM, e.g. 2x2") from None
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"--mesh {text!r}: expected DxM or PxDxM")
    return shape
