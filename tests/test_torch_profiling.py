"""The port's profiling utilities (``utils/profiling.py``) against the JAX
package's: ``PhaseTimer`` keeps the same ``phases`` and prints the same
report; ``trace`` writes a Chrome trace with the ``annotate`` ranges nested
in it; the trainer's ``phase_ms`` comes from its ``PhaseTimer``."""

import json
import os

import torch

from longlive_torch.utils import profiling as TP
from longlive_tpu.utils import profiling as JP


def test_phase_timer_report_matches_jax():
    phases = {"init": [0.0125], "block": [0.5, 0.25, 0.125], "vae": [0.0375, 0.04]}
    t, j = TP.PhaseTimer(), JP.PhaseTimer()
    t.phases = {k: list(v) for k, v in phases.items()}
    j.phases = {k: list(v) for k, v in phases.items()}
    assert t.report() == j.report()
    assert TP.PhaseTimer().report() == JP.PhaseTimer().report()


def test_phase_timer_times_phases():
    timer = TP.PhaseTimer()
    x = torch.ones(4)
    for _ in range(2):
        with timer.phase("a", sync_on={"x": [x, None]}):
            x = x * 2
    with timer.phase("b"):
        pass
    assert list(timer.phases) == ["a", "b"]
    assert len(timer.phases["a"]) == 2 and len(timer.phases["b"]) == 1
    assert all(v >= 0.0 for vals in timer.phases.values() for v in vals)
    assert "over 2 calls" in timer.report()


def test_trace_writes_nested_annotations(tmp_path):
    logdir = str(tmp_path / "prof")
    with TP.trace(logdir) as prof:
        with TP.annotate("outer"):
            with TP.annotate("inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    events = json.load(open(os.path.join(logdir, "trace.json")))["traceEvents"]
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") in ("outer", "inner") and "dur" in e}
    assert set(spans) == {"outer", "inner"}
    (o0, o1), (i0, i1) = spans["outer"], spans["inner"]
    assert o0 <= i0 and i1 <= o1


def test_trainer_phase_ms_from_its_phase_timer():
    from longlive_torch.training.trainer import ScoreDistillationTrainer, TrainerConfig

    tr = ScoreDistillationTrainer.__new__(ScoreDistillationTrainer)
    tr.tcfg, tr.device = TrainerConfig(phase_ledger=True), torch.device("cpu")
    tr.phase_timer, tr.page_bytes, tr.state = TP.PhaseTimer(), {}, {"step": 0}
    for name in ("critic_rollout", "critic_loss_grad", "critic_rollout"):
        with tr._phase(name):
            pass
    metrics = {}
    tr._close_step(metrics, 0)
    want = {k: sum(v) * 1e3 for k, v in tr.phase_timer.phases.items()}
    assert metrics["phase_ms"] == want and list(want) == ["critic_rollout", "critic_loss_grad"]
    tr._clear_phases()
    assert tr.phase_timer.phases == {}
    off = ScoreDistillationTrainer.__new__(ScoreDistillationTrainer)
    off.tcfg, off.phase_timer, off.page_bytes, off.state = TrainerConfig(), None, {}, {"step": 0}
    with off._phase("x"):
        pass
    metrics = {}
    off._close_step(metrics, 0)
    assert "phase_ms" not in metrics
