"""The port's ``workloads/sharding.py`` against the reference's.

``default_axis_sizes`` is a copy and must factor every device count as
the reference does; ``make_mesh`` builds a ``DeviceMesh`` with the four
canonical axes over the ranks of a process group, here a world-1 gloo
group on the CPU.
"""
import math

import pytest
from torch import distributed as dist

from kubernetes_tpu.workloads import sharding as ref
from kubernetes_tpu_torch.workloads import sharding


@pytest.mark.parametrize("n", range(1, 65))
def test_default_axis_sizes_match_the_reference(n):
    sizes = sharding.default_axis_sizes(n)
    assert sizes == ref.default_axis_sizes(n)
    assert sizes["dp"] * sizes["fsdp"] * sizes["sp"] * sizes["tp"] == n


def test_axes_match_the_reference():
    assert sharding.AXES == ref.AXES


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_make_mesh_has_the_four_axes(world_of_one):
    mesh = sharding.make_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("dp", "fsdp", "sp", "tp")
    assert tuple(mesh.mesh.shape) == (1, 1, 1, 1)
    assert mesh.device_type == "cpu"
    assert all(mesh[axis].size() == 1 for axis in sharding.AXES)
    assert list(mesh.get_coordinate()) == [0, 0, 0, 0]


def test_mesh_for_one_device_is_pure_dp(world_of_one):
    mesh = sharding.mesh_for(1, device_type="cpu")
    assert mesh.mesh_dim_names == sharding.AXES
    assert mesh.size() == 1


def test_make_mesh_refuses_more_devices_than_ranks(world_of_one):
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        sharding.make_mesh(dp=2, device_type="cpu")


def test_specs_match_the_reference():
    assert sharding.ACT_SPEC == tuple(ref.ACT_SPEC)
    assert sharding.DATA_SPEC == tuple(ref.DATA_SPEC)


@pytest.mark.parametrize("sizes", [dict(dp=2, sp=2), dict(dp=2, fsdp=2),
                                   dict(sp=4), dict(dp=4, sp=2),
                                   dict(fsdp=2, sp=2, tp=2)])
@pytest.mark.parametrize("spec_name", ["DATA_SPEC", "ACT_SPEC"])
def test_block_is_the_reference_shard_of_each_device(sizes, spec_name):
    """Every device's block of a global array under the reference's
    spec, as ``jax.device_put`` with a ``NamedSharding`` lays it out on
    a mesh of the CPU devices ``tests/conftest.py`` gives JAX."""
    import jax
    import numpy as np
    import torch
    from jax.sharding import NamedSharding
    full = {**dict.fromkeys(sharding.AXES, 1), **sizes}
    mesh = ref.make_mesh(jax.devices()[:math.prod(full.values())], **full)
    shape = (8, 16) if spec_name == "DATA_SPEC" else (8, 16, 3)
    x = np.arange(math.prod(shape), dtype=np.float32).reshape(shape)
    placed = jax.device_put(
        x, NamedSharding(mesh, getattr(ref, spec_name)))
    coords = {dev: dict(zip(sharding.AXES, map(int, idx)))
              for idx, dev in np.ndenumerate(mesh.devices)}
    for piece in placed.addressable_shards:
        got = sharding.block(torch.from_numpy(x),
                             getattr(sharding, spec_name), full,
                             coords[piece.device])
        np.testing.assert_array_equal(got.numpy(), np.asarray(piece.data))


def test_shard_without_a_mesh_or_on_a_mesh_of_one_is_the_tensor(
        world_of_one):
    import torch
    x = torch.arange(24).reshape(2, 12)
    assert sharding.shard(None, x, sharding.DATA_SPEC) is x
    mesh = sharding.make_mesh(device_type="cpu")
    assert torch.equal(sharding.shard(mesh, x, sharding.DATA_SPEC), x)
    assert sharding.mesh_sizes(mesh) == dict.fromkeys(sharding.AXES, 1)
    assert sharding.mesh_sizes(None) == dict.fromkeys(sharding.AXES, 1)


def test_block_refuses_a_dim_that_does_not_split_evenly():
    import torch
    sizes = {**dict.fromkeys(sharding.AXES, 1), "sp": 4}
    with pytest.raises(ValueError, match="does not split evenly"):
        sharding.block(torch.zeros((2, 6)), sharding.DATA_SPEC, sizes,
                       dict.fromkeys(sharding.AXES, 0))
