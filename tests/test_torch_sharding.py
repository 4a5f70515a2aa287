"""The port's ``workloads/sharding.py`` against the reference's.

``default_axis_sizes`` is a copy and must factor every device count as
the reference does; ``make_mesh`` builds a ``DeviceMesh`` with the four
canonical axes over the ranks of a process group, here a world-1 gloo
group on the CPU.
"""
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
