"""The frozen counts equal hand counts, and the port's own at the commit
they were copied from."""

import pytest

from ntp_bench import cost


def test_partitions_and_epilogue_by_hand():
    assert [len(cost.partitions(k)) for k in range(1, 8)] == [1, 2, 3, 5, 7, 11, 15]
    # order 2: partitions {1}: 2 + 1, {2}: 2 + 1, {1, 1}: 2 + 2; Horner 2 + 4 + 6
    assert cost.flop_estimate(2, 1, 1) == 3 + 3 + 4 + 12
    assert cost.flop_estimate(2, 5, 3) == 22 * 15


def test_dense_by_hand():
    # (3, 10, 4) x (4, 5) + bias, tanh: GEMM 2*3*10*4*5, bias 10*5, epilogue 22*10*5
    layer = cost.dense(10, 4, 5, 3, True, "float64")
    assert layer.flops == 1200 + 50 + 1100
    assert layer.nbytes == (3 * 10 * 4 + 20 + 5 + 3 * 10 * 5) * 8
    assert cost.dense(10, 4, 5, 3, False, "float64").flops == 1250


def test_attention_and_rms_norm_by_hand():
    # rows 2, heads 2, 2 tokens, head 3, model 6, n1 2
    a = cost.flash_attention(2, 2, 2, 3, 6, 2, "float64")
    pairs = 2 * 2 * 2 * 2
    assert a.flops == pairs * (2 * 2 * 3 * 3 + 2 * 4) + 2 * 2 * 2 * 4 * 3 + 2 * 2 * 2 * 2 * 2 * 3 * 6
    assert a.nbytes == (3 * 2 * 2 * 2 * 2 * 3 + 2 * 3 * 6 + 2 * 2 * 2 * 6) * 8
    r = cost.rms_norm(4, 6, 3, "float32")
    assert r.flops == 4 * 6 * (2 * 3 * 4 + 3) + 4 * 9
    assert r.nbytes == (2 * 3 * 4 * 6 + 6) * 4


def test_bound_is_the_larger_term():
    layer = cost.Layer("K1", int(3.35e12), int(67e12 * 2))
    assert layer.bound_s == pytest.approx(2.0)


def test_network_layer_lists():
    mlp = {"network": "dense", "d_in": 1, "width": 24, "depth": 3, "d_out": 1,
           "net_kwargs": {}, "dtype": "float64"}
    assert [l.family for l in cost.jet_forward(mlp, 8, 11)] == ["K1"] * 4
    assert len(cost.jet_forward(mlp, 8, 11, readout_on_kernel=False)) == 3
    trunk = {"network": "transformer", "d_in": 2, "width": 32, "depth": 3, "d_out": 1,
             "net_kwargs": {"n_heads": 2, "mlp_ratio": 2}, "dtype": "float64"}
    fams = [l.family for l in cost.jet_forward(trunk, 8, 5)]
    assert (fams.count("K1"), fams.count("K3"), fams.count("K4")) == (16, 7, 3)


@pytest.mark.parametrize("n", range(0, 13))
def test_epilogue_count_equals_the_ports_at_the_copy(n):
    from repro_torch.kernels.bell_tables import flop_estimate
    assert cost.flop_estimate(n, 7, 5) == flop_estimate(n, 7, 5)
