"""Mesh descriptions and host meshes.

PyTorch counterpart of ``repro.launch.mesh``.  Importing this module
touches no device and no process group: ``make_production_mesh`` returns a
description, and ``make_host_mesh`` reads the process group the caller has
already initialized.

* ``Mesh`` names mesh axes and their sizes and holds nothing else: the
  port's counterpart of ``jax.sharding.AbstractMesh``.  The placement rules
  (``distributed.sharding``) read only this, so they run for meshes no
  program here spans.
* ``make_host_mesh`` builds a real ``DeviceMesh`` over the default process
  group, as the reference builds its host mesh over the visible devices.
* ``_axis_sizes`` reads ``{axis name: size}`` from either.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh description: ``axis_names`` in mesh order and their sizes.
    ``shape`` is ``{name: size}``, as ``AbstractMesh.shape`` is."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes {self.axis_sizes} "
                             "differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes as descriptions: (16, 16) over
    ``("data", "model")``, or (2, 16, 16) over ``("pod", "data",
    "model")``.  The port has no 256- or 512-rank program to run on them;
    the shapes are kept so that the port's placement plans can be held
    against the reference's ``PartitionSpec`` trees and so that the dry run
    (``launch.dryrun``) reports per-rank bytes at the reference's scale."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(model: int = 1, *, device: str = "cpu"):
    """A ``(world // model, model)`` ``DeviceMesh`` over ``("data",
    "model")`` on the default process group, which the caller has
    initialized (gloo for ``cpu``, NCCL for ``cuda``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: initialize the default process group "
                           "first (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if model < 1 or n % model != 0:
        raise ValueError(
            f"model-axis width {model} does not divide the world size {n}; pick "
            f"a divisor of {n}, or start more ranks (init_process_group's "
            f"world_size) so that {max(model, 1)} divides it")
    return init_device_mesh(device, (n // model, model),
                            mesh_dim_names=("data", "model"))


def _axis_sizes(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` of a ``Mesh`` description or a ``DeviceMesh``."""
    if isinstance(mesh, Mesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
