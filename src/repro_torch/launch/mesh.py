"""Production mesh of the port (the port of ``repro/launch/mesh.py``).

A mesh here is a :class:`Mesh`: a frozen description, axis names and
sizes in ``repro``'s order, that touches no device and no process group
when it is made. ``Mesh.device_mesh()`` builds the matching
``torch.distributed.device_mesh.DeviceMesh`` once a process group of
exactly ``Mesh.size`` ranks is running; the sharding rules
(``repro_torch.parallel.sharding``) need only the description.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.dims) \
                or len(set(self.axis_names)) != len(self.axis_names) \
                or min(self.dims, default=1) < 1:
            raise ValueError(f"a mesh needs distinct axis names, one "
                             f"size >= 1 each; got {self.axis_names}, "
                             f"{self.dims}")

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, in axis order (``jax``'s ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    @property
    def empty(self) -> bool:
        return not self.axis_names

    def device_mesh(self, device_type: str = "cuda"):
        """The ``DeviceMesh`` of this shape over the running default
        process group, which must have exactly ``size`` ranks."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        world = dist.get_world_size() if dist.is_initialized() else 0
        if world != self.size:
            raise RuntimeError(
                f"a {self.shape} mesh needs a process group of {self.size} "
                f"ranks; {'none is' if not world else f'{world} are'} "
                f"running")
        return init_device_mesh(device_type, self.dims,
                                mesh_dim_names=self.axis_names)


EMPTY = Mesh((), ())
_CURRENT: list = []


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod.

    Axes: 'data' (DP/FSDP), 'model' (TP/EP/SP), plus 'pod' (hierarchical
    DP) on the multi-pod mesh.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_mesh(shape, axes) -> Mesh:
    """Arbitrary mesh helper (tests, examples, one card: (1, 1))."""
    return Mesh(tuple(axes), tuple(int(d) for d in shape))


@contextlib.contextmanager
def set_mesh(mesh: Mesh):
    """Install ``mesh`` as the current one for the enclosed block
    (``repro_torch.parallel.sharding.get_abstract_mesh`` reads it)."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh() -> Optional[Mesh]:
    return _CURRENT[-1] if _CURRENT else None
