"""The end-to-end numbers on synthetic timings: a tail counts every
request from its due time, failures at the time the run gave up, and a
rate or a share is taken over the whole window."""

import numpy as np
import pytest

from ntp_bench import cost
from ntp_bench.common import Readings
from ntp_bench.metrics import idle_pct, mfu_pct, roofline_pct
from ntp_bench.trace import reduce_events
from ntp_bench.traffic.open_loop import latencies, nearest_rank, schedule


def test_p95_is_from_due_times_and_counts_failures():
    due = np.arange(100) * 0.01
    done = due + 0.005                     # 5 ms after each due time ...
    done[:2] = due[:2] + 0.5               # ... two waited 500 ms ...
    failed = np.zeros(100, dtype=bool)
    failed[50:52] = True                   # ... and two failed
    done[50:52] = np.nan
    lat = latencies(due, done, failed, end=2.0)
    assert lat[0] == pytest.approx(0.5) and lat[50] == pytest.approx(2.0 - 0.5)
    assert nearest_rank(lat, 0.95) == pytest.approx(0.005)
    failed[60:62] = True                   # 6 of 100 late or missed
    lat = latencies(due, done, failed, end=2.0)
    assert nearest_rank(lat, 0.95) == pytest.approx(0.5)


def test_schedule_is_the_cells_not_the_seeds():
    wl = {"rate_per_s": 50.0, "mix_seed": 0, "rows_min": 8, "rows_max": 64,
          "mix": [{"share": 0.5}, {"share": 0.5}]}
    a, b = schedule(wl, 4.0), schedule(wl, 4.0)
    assert len(a["due"]) == 200 and np.array_equal(a["due"], b["due"])
    assert a["due"][0] == 0 and a["due"][-1] < 4.0
    assert (a["kind"] == 0).sum() == 100
    assert a["rows"].min() >= 8 and a["rows"].max() <= 64


def test_busy_time_is_the_union_over_the_whole_window():
    ev = [("kernel", "void jet_dense_kernel<double, 3>(double const*)", 100, 300, True),
          ("kernel", "void at::native::add_kernel(float)", 200, 400, True),
          ("gpu_memcpy", "Memcpy DtoD", 600, 700, True),
          ("cpu_op", "aten::add", 380, 650, False),
          ("kernel", "void jet_dense_rt_kernel<double>(double const*)", 900, 1200, True)]
    tr = reduce_events(ev, 0, 1000)
    assert tr.window_s == pytest.approx(1000e-9)
    assert tr.busy_s == pytest.approx((300 + 100 + 100) * 1e-9)
    assert tr.kernels == 3
    assert tr.family_s["K1"] == pytest.approx(300e-9)
    assert tr.family_s["eager"] == pytest.approx(300e-9)
    gaps = dict(tr.idle_gaps)
    assert gaps["aten::add"] == pytest.approx(200e-9)
    r = Readings(kind="table", window_s=1.0, units=4, trace=tr)
    assert idle_pct(r, "table") == pytest.approx(50.0)


def test_shares_of_peak_and_bound():
    layer = cost.Layer("K1", nbytes=0, flops=int(67e12 * 0.01))    # bound 10 ms
    tr = reduce_events([("kernel", "jet_dense_kernel", 0, 40_000_000, True)], 0, 10**9)
    r = Readings(kind="train", window_s=1.0, units=2, trace=tr, layers=[(layer, 2)],
                 model_flops=3 * 2 * layer.flops)
    assert roofline_pct(r, "K1", "train") == pytest.approx(50.0)
    assert mfu_pct(r, "train") == pytest.approx(6.0)
    assert roofline_pct(r, "K4", "train") is None and mfu_pct(r, "serve") is None
