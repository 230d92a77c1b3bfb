"""The port's fault-tolerant runtime (``repro_torch.runtime.Trainer``) and
checkpoint manager semantics, on the cases of the reference's
``tests/test_runtime.py``: a clean run and injected failures, preemption,
the straggler watchdog, round trip and garbage collection, async save and
atomicity, the elastic dtype cast.  Beside them: retries past
``max_retries`` re-raise, a state overwritten in place right after
``save(blocking=False)`` still restores as it was saved, and both
constructors need the card unless told ``device="cpu"``.

The problem is the reference's: gradient descent on ``|p - (3, -1)|^2``
with a step counter, ``state = (params, t)``."""

import os
import signal
import threading
import time
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt import manager as manager_mod
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.tree import bit_equal

TARGET = torch.tensor([3.0, -1.0])


def quad_step(state, batch):
    params, opt_t = state
    g = 2.0 * (params - TARGET)
    return (params - 0.05 * g, opt_t + 1), torch.sum((params - TARGET) ** 2)


def quad_problem(tmp_path, total=40, ckpt_every=10, **kw):
    cfg = TrainerConfig(total_steps=total, ckpt_every=ckpt_every, ckpt_dir=str(tmp_path),
                        **{"max_retries": 5, **kw})
    return cfg, quad_step


def _start():
    return torch.zeros(2), torch.tensor(0)


@pytest.mark.parametrize("fail_at", [None, 25], ids=["clean", "injected_failure"])
def test_trainer_runs_and_recovers(tmp_path, fail_at, monkeypatch):
    """Clean: 40 steps, no restart, the loss falls.  A failure at step 25
    (once): one restart from the step-20 checkpoint, whose asynchronous
    save is still being written (the writer is slowed down here) and is
    waited for, then the run ends with the same state as the clean run
    (the step is deterministic)."""
    real = manager_mod.np.savez
    monkeypatch.setattr(manager_mod.np, "savez",
                        lambda *a, **k: (time.sleep(0.2), real(*a, **k))[1])
    cfg, step = quad_problem(tmp_path)
    boom = {fail_at}

    def injector(s):
        if s in boom:
            boom.clear()          # fail exactly once
            raise RuntimeError("injected node failure")

    tr = Trainer(cfg, step, lambda s: None, device="cpu")
    (params, t), rep = tr.run(_start(), fail_injector=injector)
    assert rep.restarts == (0 if fail_at is None else 1)
    assert rep.steps_run == 40 + (0 if fail_at is None else 25 - 20)
    assert int(t) == 40 and rep.losses[-1] < 0.5 and rep.losses[-1] < rep.losses[0]
    clean, _ = Trainer(replace(cfg, ckpt_dir=str(tmp_path / "clean")), step,
                       lambda s: None, device="cpu").run(_start())
    assert bit_equal((params, t), clean)


def test_trainer_reraises_past_max_retries_and_restores_the_sigterm_handler(tmp_path):
    """Failures with no step done between them: a step that fails at the
    checkpoint it restores from.  A success resets the count, as in the
    reference."""
    cfg, step = quad_problem(tmp_path, max_retries=2)
    seen, before = [], signal.getsignal(signal.SIGTERM)

    def injector(s):
        if s == 10:
            seen.append(s)
            raise RuntimeError("persistent node failure")

    with pytest.raises(RuntimeError, match="persistent"):
        Trainer(cfg, step, lambda s: None, device="cpu").run(_start(), fail_injector=injector)
    assert len(seen) == 3           # the first try and two retries
    assert signal.getsignal(signal.SIGTERM) is before


def test_trainer_resumes_from_the_latest_checkpoint_at_boot(tmp_path):
    cfg, step = quad_problem(tmp_path, total=20)
    Trainer(cfg, step, lambda s: None, device="cpu").run(_start())
    (params, t), rep = Trainer(replace(cfg, total_steps=30), step, lambda s: None,
                               device="cpu").run(_start())
    assert rep.steps_run == 10 and int(t) == 30 and rep.restarts == 0


@pytest.mark.parametrize("how", ["request_preempt", "sigterm"])
def test_trainer_preemption_checkpoints_and_exits(tmp_path, how):
    if how == "sigterm" and threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers are set on the main thread only")
    cfg, step = quad_problem(tmp_path, total=1000, ckpt_every=100)
    tr = Trainer(cfg, step, lambda s: None, device="cpu")
    calls = {"n": 0}

    def batch_fn(s):
        calls["n"] += 1
        if calls["n"] == 7:
            if how == "sigterm":
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                tr.request_preempt()
        return None

    tr.batch_fn = batch_fn
    (params, t), rep = tr.run(_start())
    assert rep.preempted and rep.steps_run == 7
    assert tr.ckpt.latest_step() == 7          # state saved at the boundary
    back = tr.ckpt.restore(7, (torch.zeros(2), torch.tensor(0)))
    assert bit_equal(back, (params, t))


def test_straggler_watchdog(tmp_path):
    """Step 10 stalls 0.5 s and is the first step flagged.  Every step
    sleeps 30 ms first, so the EMA the watchdog compares against sits far
    above the host's jitter: with microsecond steps a scheduler or GC pause
    of a loaded worker is already 3x the EMA and would be flagged first."""
    cfg, step = quad_problem(tmp_path, total=20)
    hits = []

    def batch_fn(s):
        time.sleep(0.03)
        if s == 10:
            time.sleep(0.5)
        return None

    tr = Trainer(cfg, step, batch_fn, straggler_cb=lambda s, dt, ema: hits.append(s),
                 device="cpu")
    _, rep = tr.run(_start())
    assert hits and hits[0] == 10 and rep.stragglers == len(hits)


def test_trainer_needs_the_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, step = quad_problem(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, step, lambda s: None)


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------

def test_ckpt_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.zeros(4), torch.ones(2)]}
    for step in (10, 20, 30):
        mgr.save(step, tree, blocking=True)
    assert mgr.all_steps() == [20, 30]  # keep=2 garbage-collects step 10
    like = {"a": torch.zeros(2, 3), "b": [torch.zeros(4), torch.zeros(2)]}
    assert bit_equal(mgr.restore(30, like), tree)


def test_ckpt_async_and_atomicity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, {"w": torch.full((128, 128), 7.0)}, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 5
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_ckpt_holds_what_was_saved_when_the_state_is_overwritten_after_async_save(
        tmp_path, monkeypatch):
    """``save(blocking=False)`` copies to the host before it returns: the
    caller overwrites its tensors in place at once (the writer thread is
    held until then), and the checkpoint holds the values at the save."""
    gate, real = threading.Event(), manager_mod.np.savez

    def held(*args, **kwargs):
        assert gate.wait(30)
        return real(*args, **kwargs)

    monkeypatch.setattr(manager_mod.np, "savez", held)
    state = (torch.linspace(-1.0, 1.0, 1000, dtype=torch.float64), torch.tensor(3))
    saved = tuple(t.clone() for t in state)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=False)
    state[0].mul_(-2.0).add_(5.0)
    state[1].add_(1)
    gate.set()
    mgr.wait()
    back = mgr.restore(1, (torch.zeros(1000, dtype=torch.float64), torch.tensor(0)))
    assert bit_equal(back, saved) and not bit_equal(back, state)


def test_ckpt_elastic_restore_dtype_cast(tmp_path):
    """Restore maps onto a like-tree with another dtype (an elastic restart
    may change the precision policy)."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(4, dtype=torch.float32)}, blocking=True)
    back = mgr.restore(1, {"w": torch.zeros(4, dtype=torch.bfloat16)})
    assert back["w"].dtype == torch.bfloat16 and bit_equal(back["w"], torch.ones(4).bfloat16())
