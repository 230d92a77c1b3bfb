"""Device-mesh construction.

Functions, not module-level constants: importing this module touches no
device or process-group state.  Each builds a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, which the caller has initialised (``torch.distributed`` reads no
cluster description of its own: give ``init_process_group`` its address,
world size and rank), with the JAX package's axis names.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.device import resolve_device


def _mesh(device_type: str, sizes: Dict[str, int]):
    from torch.distributed.device_mesh import init_device_mesh
    resolve_device(device_type)  # a CUDA mesh raises where there is no GPU
    return init_device_mesh(device_type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def production_sizes(multi_pod: bool = False) -> Dict[str, int]:
    """{axis name: size} of the production mesh: 16 x 16 ("data",
    "model"), or (2, 16, 16) ("pod", "data", "model") with ``multi_pod``.
    ``make_rules`` and ``launch.sharding``'s binders plan the production
    meshes from this mapping without their ranks."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh (``production_sizes``); needs that many ranks."""
    return _mesh(device_type, production_sizes(multi_pod))


def make_debug_mesh(n_data: int = 2, n_model: int = 2, device_type: str = "cuda"):
    """A small (n_data, n_model) ("data", "model") mesh: world size 1 on one
    card, or gloo ranks on the CPU in the tests."""
    return _mesh(device_type, {"data": n_data, "model": n_model})
