"""Production meshes, elastic re-meshing and the fake world they live in.

The port of ``repro.launch.mesh``. The reference builds its meshes from the
512 host devices that ``--xla_force_host_platform_device_count=512`` gives
its launchers; the port's twin is ``fake_world``: one process standing in
for N ranks through torch's fake process group, which runs no collective
and moves no byte (the launchers count them instead). Only the dry-run
launchers (``dryrun``, ``roofline_run``, ``perf_probe``) bring it up, inside
their own processes; importing this module touches no process-group state,
and the serving and training paths never see a mesh.

Single pod: 16x16 = 256 ranks, axes (data, model). Multi-pod: 2x16x16 = 512
ranks, axes (pod, data, model); the "pod" axis is the cross-pod dimension.
A mesh holds ranks 0..n-1 of the fake world, so one world of 512 hosts both.

``elastic_mesh`` recomputes the largest valid (data, model) mesh from the
devices that remain when hosts drop (the reference's arithmetic and error).
"""

from __future__ import annotations

import math

__all__ = ["make_production_mesh", "elastic_mesh", "elastic_shape", "data_axis_size", "mesh_axis",
           "fake_world", "make_mesh", "WORLD"]

WORLD = 512  # ranks of the fake world the launchers bring up (the reference's host devices)


def fake_world(n: int = WORLD) -> int:
    """Bring up torch's fake process group of ``n`` ranks in this process,
    this process being rank 0 (a no-op when a world of at least ``n`` ranks
    is already up). Returns the world size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() >= n:
            return dist.get_world_size()
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return n


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ranks 0..prod(shape)-1 of the fake world (brought
    up here if it is not up or too small), on the host."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    fake_world(max(n, WORLD))
    return DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def elastic_shape(n_available: int, *, model_parallel: int = 16) -> tuple[int, int]:
    """(data, model) of the largest mesh from n_available devices.

    Keeps model-parallel width fixed (param shardings stay valid) and shrinks
    the data axis to the largest count that fits, dropping to the next power
    of two so batch re-sharding stays divisible. Raises if fewer than one
    model-parallel group survives.
    """
    if n_available < model_parallel:
        raise ValueError(f"{n_available} devices cannot host model_parallel={model_parallel}")
    return 1 << int(math.log2(n_available // model_parallel)), model_parallel


def elastic_mesh(n_available: int, *, model_parallel: int = 16):
    """The (data, model) mesh of ``elastic_shape``."""
    return make_mesh(elastic_shape(n_available, model_parallel=model_parallel), ("data", "model"))


def data_axis_size(mesh) -> int:
    return mesh_axis(mesh, "data")


def mesh_axis(mesh, name: str) -> int:
    from repro_torch.sharding.partition import axis_sizes

    return int(axis_sizes(mesh).get(name, 1))
