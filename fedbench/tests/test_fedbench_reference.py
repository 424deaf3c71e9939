"""The plain logistic regression's protocol against tiny CPU runs of the
port, and the comparison's verdict on the lower-precision control and
planted faults."""
import math

import pytest
import torch

from _small import LOGREG, run


@pytest.mark.parametrize("seconds", [0.2, 30.0])
def test_logreg_reference_agrees_with_the_port(seconds):
    """A window of one tick, and the cell's whole window of 40 ticks,
    whose end the check reads as well."""
    res, _ = run("logreg_fig1b_dp", LOGREG, seed=2 ** 31 + 11,
                 seconds=seconds)
    assert res["correct"], res["compared"]
    assert res["compared"]["protocol_mismatches"]["value"] == 0
    assert res["compared"]["rows_gap"]["value"] < 1e-5


def _tick_unchanged(monkeypatch):
    from repro_torch.cohort.device import DeviceCohortEngine
    inner = DeviceCohortEngine._tick

    def tick(self, st, t, sk0):
        new, p = inner(self, st, t, sk0)
        return st._replace(tick=new.tick), p
    monkeypatch.setattr(DeviceCohortEngine, "_tick", tick)


def _half_the_clients(monkeypatch):
    from repro_torch.cohort.tasks import CohortLogRegTask
    inner = CohortLogRegTask.run_block

    def run_block(self, w, U, i, h, n, eta, block, idx=None):
        w2, U2 = inner(self, w, U, i, h, n, eta, block, idx)
        m = w.shape[0] // 2
        return torch.cat([w2[:m], w[m:]]), torch.cat([U2[:m], U[m:]])
    monkeypatch.setattr(CohortLogRegTask, "run_block", run_block)


def _answer_altered(monkeypatch):
    from repro_torch.cohort.device import DeviceCohortEngine
    inner = DeviceCohortEngine._clip_noise

    def clip_noise(self, U, eta, done, t):
        sent = inner(self, U, eta, done, t).clone()
        sent[0] = -sent[0]
        return sent
    monkeypatch.setattr(DeviceCohortEngine, "_clip_noise", clip_noise)


@pytest.mark.parametrize("fault", [_tick_unchanged, _half_the_clients,
                                   _answer_altered])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    """The harness's whole run, the program broken underneath: one
    planted fault a case (a cell on one chip has no exchange to drop)."""
    fault(monkeypatch)
    res, _ = run("logreg_fig1b_dp", LOGREG)
    assert not res["correct"]
    assert res["failed"] > 0


def test_logreg_control_and_faults_fail_the_limits():
    """The reference in bfloat16 in the program's place fails; so does
    each fault planted in the reference."""
    from fedbench import control
    got = {r["kind"]: r for r in control.readings(
        "logreg_fig1b_dp", [3], device="cpu", overrides=LOGREG)}
    assert set(got) == set(control.KINDS)
    for kind, r in got.items():
        assert r["caught"], (kind, r["numbers"])
    assert got["control"]["numbers"]["protocol_mismatches"] == 0
    assert not math.isnan(got["control"]["numbers"]["rows_gap"])


def test_a_fault_late_in_the_window_is_not_correct(monkeypatch):
    """A client block that goes wrong only in rounds the set-up's ticks
    never reach: the window's end, read for the check, shows it."""
    from repro_torch.cohort.tasks import CohortLogRegTask
    inner = CohortLogRegTask.run_block

    def run_block(self, w, U, i, h, n, eta, block, idx=None):
        w2, U2 = inner(self, w, U, i, h, n, eta, block, idx)
        late = (i >= 20)[:, None]
        return w2, torch.where(late, U2 * 2.0, U2)
    monkeypatch.setattr(CohortLogRegTask, "run_block", run_block)
    res, _ = run("logreg_fig1b_dp", LOGREG, seconds=30.0)
    assert not res["correct"], res["compared"]
