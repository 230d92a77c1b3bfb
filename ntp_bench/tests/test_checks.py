"""What decides ``correct``: sound runs pass; the control (the reference in
float32 put in the program's place) and each fault a cell can have, planted
in the timed path, fail."""

import pytest
import torch

from ntp_bench.tests.conftest import CELLS, run_small

TRAIN = ("burgers-k4-train", "trunk-heat-train")
TABLES = ("trunk-serve", "mlp-table-o10")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(cell):
    out, _ = run_small(cell)
    assert out.checks and all(c.ok for c in out.checks), out.checks
    control = out.controls()["control_float32"]
    assert any(control[c.name] > c.limit for c in out.checks), control


@pytest.mark.parametrize("cell", TRAIN)
def test_faults_of_a_training_cell_read_above_their_limits(cell):
    out, _ = run_small(cell)
    limits = {c.name: c.limit for c in out.checks}
    faults = out.controls()
    for name in ("half_batch", "state_unchanged"):
        assert any(faults[name][k] > limits[k] for k in limits), (name, faults[name])


@pytest.mark.parametrize("cell", TRAIN)
def test_float32_rounding_of_a_moved_gradient_stays_under_the_limits(cell):
    """Gradients moved by 1e-9 cross float32 rounding points in Adam: the
    float32 numbers stay under their limits, the float64 gradient's not."""
    out, _ = run_small(cell)
    limits = {c.name: c.limit for c in out.checks}
    probe = out.controls()["nudged_1e-9"]
    assert all(probe[k] <= limits[k] for k in ("loss_gap", "grad_gap", "change_gap")), probe
    assert probe["grad64_gap"] > limits["grad64_gap"]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_backward_rounded_to_float32_is_caught(cell, monkeypatch):
    from repro_torch.pinn import trainer
    from repro_torch.tree import leaves, unflatten
    real = trainer.value_and_grad

    def rounded(loss_fn, ps, *batch):
        value, grads = real(loss_fn, ps, *batch)
        return value, unflatten(grads, [g.float().double() for g in leaves(grads)])

    monkeypatch.setattr(trainer, "value_and_grad", rounded)
    out, _ = run_small(cell)
    assert {c.name for c in out.checks if not c.ok} == {"grad64_gap"}


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_returns_its_state_unchanged_is_caught(cell, monkeypatch):
    from repro_torch.pinn import trainer
    real = trainer.adam_step

    def frozen(loss_fn, ps, state, lr, *batch):
        _, _, loss, aux = real(loss_fn, ps, state, lr, *batch)
        return ps, state, loss, aux

    monkeypatch.setattr(trainer, "adam_step", frozen)
    out, _ = run_small(cell)
    assert not all(c.ok for c in out.checks)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_the_batch_left_out_is_caught(cell, monkeypatch):
    from repro_torch.pinn import trainer
    if cell == "burgers-k4-train":
        real = trainer.burgers_pinn_loss

        def half(p, lr, *, pts, origin_pts, **kw):
            return real(p, lr, pts=pts[:pts.shape[0] // 2],
                        origin_pts=origin_pts[:origin_pts.shape[0] // 2], **kw)

        monkeypatch.setattr(trainer, "burgers_pinn_loss", half)
    else:
        real = trainer.pinn_loss

        def half(p, *, pts, **kw):
            return real(p, pts=pts[:pts.shape[0] // 2], **kw)

        monkeypatch.setattr(trainer, "pinn_loss", half)
    out, _ = run_small(cell)
    assert not all(c.ok for c in out.checks)


@pytest.mark.parametrize("cell", TABLES)
def test_an_answer_altered_where_it_is_produced_is_caught(cell, monkeypatch):
    from repro_torch.core.engines import NTPEngine
    real = NTPEngine.derivs

    def altered(self, *a, **kw):
        d = real(self, *a, **kw).clone()
        d[-1] *= 1 + 1e-6               # the top order of every answer
        return d

    monkeypatch.setattr(NTPEngine, "derivs", altered)
    out, _ = run_small(cell)
    assert not all(c.ok for c in out.checks)


def test_a_traced_run_gives_the_per_layer_readings():
    out, ctx = run_small("mlp-table-o10", trace=True)
    assert out.readings.trace is not None and out.readings.trace.window_s > 0
    assert out.readings.units > 0 and out.readings.model_flops > 0
    assert torch.device("cpu") == ctx.device
