"""Device meshes over ``torch.distributed``: the port of the JAX package's
``launch/mesh.py``, with the same shapes and axis names.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, which must be initialised first. Functions, not
module-level constants, so importing this module touches no process group
and no device.

``init_device_mesh`` sets each rank's CUDA device to ``LOCAL_RANK`` unless
CUDA is initialised already. Several ranks that share one card (gloo ranks
on a one-card machine) therefore call ``torch.cuda.set_device`` on their
own device before they build a mesh.
"""
from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(n_data: int = 2, n_model: int = 2, *,
                   device_type: str = "cpu"):
    """Small mesh for tests (``n_data * n_model`` ranks)."""
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def make_dp_mesh(n_data: int, *, device_type: str = "cuda"):
    """The 1-D ``("data",)`` mesh the trainers take their data-parallel
    group from (``mesh.get_group("data")``), as the JAX trainer builds
    ``jax.make_mesh((n_dev,), ("data",))``."""
    return init_device_mesh(device_type, (n_data,),
                            mesh_dim_names=("data",))


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def dp_size(mesh) -> int:
    sizes = mesh_axis_sizes(mesh)
    out = 1
    for a in dp_axes(mesh):
        out *= sizes[a]
    return out
