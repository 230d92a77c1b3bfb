"""The port's roofline (``repro_torch.launch.op_analysis``): ``model_flops``
equal to the reference's ``hlo_analysis.model_flops`` for every arch,
shape and chip count of the production meshes; a hand-worked
``Roofline.finalize`` with the H100 data-sheet constants; the link each
mesh dim gets."""

import functools
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as jget_arch
from repro.launch import hlo_analysis as jhlo
from repro.launch import sharding as jsharding
from repro_torch.configs import ASSIGNED, SHAPES, get_arch
from repro_torch.launch import op_analysis as oa
from repro_torch.launch import sharding


@pytest.fixture(scope="module")
def counts():
    """Each package's parameter count, once an arch."""
    with mock.patch.object(jsharding, "arch_param_count",
                           functools.lru_cache(jsharding.arch_param_count)), \
            mock.patch.object(sharding, "arch_param_count",
                              functools.lru_cache(sharding.arch_param_count)):
        yield


@pytest.mark.parametrize("arch", ASSIGNED)
def test_model_flops_equal_reference(counts, arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    for name, shape in SHAPES.items():
        for n_chips in (256, 512):
            assert oa.model_flops(cfg, shape, n_chips) == \
                jhlo.model_flops(jcfg, JSHAPES[name], n_chips), (name, n_chips)


def test_finalize_by_hand():
    """989 GFLOP of bf16 at 989 TFLOP/s is 1 ms; 6.7 GB at 3.35 TB/s is
    2 ms; 1 GB over the 16-rank "data" dim, whose groups span hosts, at
    50 GB/s is 20 ms, and 0.45 GB over the 4-rank "model" dim, within a
    host, at 450 GB/s 1 ms: the collective term bounds it."""
    rl = oa.Roofline(arch="a", shape="s", mesh="m", n_chips=256, hlo_gflops=989.0,
                     hlo_gbytes=6.7, collective_gbytes=1.45, per_device_mem_gb=1.0,
                     model_gflops=494.5, dtype="bfloat16",
                     collective_dims={"data": 1.0, "model": 0.45},
                     mesh_sizes={"data": 16, "model": 4}).finalize()
    assert rl.compute_s == pytest.approx(1e-3, rel=1e-12)
    assert rl.memory_s == pytest.approx(2e-3, rel=1e-12)
    assert rl.collective_s == pytest.approx(20e-3 + 1e-3, rel=1e-12)
    assert rl.bottleneck == "collective"
    assert rl.bound_s == rl.collective_s
    assert rl.useful_fraction == 0.5
    f64 = oa.Roofline(arch="a", shape="s", mesh="m", n_chips=1, hlo_gflops=67.0,
                      hlo_gbytes=0.0, collective_gbytes=0.0, per_device_mem_gb=0.0,
                      dtype="float64").finalize()
    assert f64.compute_s == pytest.approx(1e-3, rel=1e-12) and f64.bottleneck == "compute"


@pytest.mark.parametrize("sizes,dim,bw", [
    ({"data": 16, "model": 16}, "model", oa.NIC_BW),
    ({"data": 16, "model": 16}, "data", oa.NIC_BW),
    ({"pod": 2, "data": 16, "model": 16}, "pod", oa.NIC_BW),
    ({"data": 2, "model": 4}, "model", oa.NVLINK_BW),
    ({"data": 2, "model": 4}, "data", oa.NVLINK_BW),
    ({"data": 4, "model": 4}, "data", oa.NIC_BW),
    ({"data": 1, "model": 1}, "model", oa.NVLINK_BW),
])
def test_link_of_each_mesh_dim(sizes, dim, bw):
    assert oa.link_bw(sizes, dim) == bw


def test_collective_bytes_view_of_totals():
    """The reference's per-kind dict (every kind, zeros included, counts
    under "_counts") from ``op_static.Totals``."""
    from repro_torch.launch.op_static import Totals
    t = Totals()
    t.add_collective("all-gather", 240.0, 2, "data")
    t.add_collective("all-reduce", 16.0, 1, "model")
    view = oa.collective_bytes(t)
    assert view["all-gather"] == 480.0 and view["all-reduce"] == 16.0
    assert view["all-to-all"] == 0.0 and view["collective-permute"] == 0.0
    assert view["_counts"] == {"all-gather": 2, "all-reduce": 1, "reduce-scatter": 0.0,
                               "all-to-all": 0.0, "collective-permute": 0.0}
    assert t.collective_dims == {"data": 480.0, "model": 16.0}
