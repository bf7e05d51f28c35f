"""Production mesh construction on H100 cards, after
``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
device and no process group.  A mesh of several cards needs the default
process group (``torch.distributed.init_process_group``) first.

The model axis is one NVLink domain: 8 cards joined all to all, so the
tensor-parallel collectives of every layer stay on NVLink, and the data
axes span the domains.  Single pod: ("data", "model") = (n/8, 8);
multi-pod: ("pod", "data", "model") = (2, n/16, 8).
"""

from __future__ import annotations

NVLINK_DOMAIN = 8   # cards joined all to all by NVLink in one host


def production_mesh_shape(n_cards: int, multi_pod: bool = False
                          ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The (shape, axis names) of the production mesh over ``n_cards``."""
    per_pod = 2 * NVLINK_DOMAIN if multi_pod else NVLINK_DOMAIN
    if n_cards < per_pod or n_cards % per_pod:
        raise ValueError(f"{n_cards} cards do not form "
                         f"{'2 pods of ' if multi_pod else ''}whole NVLink "
                         f"domains of {NVLINK_DOMAIN}")
    if multi_pod:
        return ((2, n_cards // per_pod, NVLINK_DOMAIN),
                ("pod", "data", "model"))
    return (n_cards // NVLINK_DOMAIN, NVLINK_DOMAIN), ("data", "model")


def make_production_mesh(n_cards: int, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh`` over ``n_cards`` cards (the default
    process group's world)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = production_mesh_shape(n_cards, multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(n: int | None = None, axis: str = "data",
                   device_type: str = "cuda"):
    """A one-axis mesh over ``n`` ranks (the default process group's
    world size when None), for examples and tests."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = n or dist.get_world_size()
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))
