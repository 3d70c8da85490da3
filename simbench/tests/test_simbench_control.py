"""The comparison fails what it must: the control (the reference in
bfloat16 in the program's place) and the run with its timed path broken
underneath.  The cells run on one card, so no exchange between cards
can be left out."""
import dataclasses

import pytest
import torch

from simbench_tiny import CELLS, ROOT, run_tiny, tiny
from simbench import control


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name):
    config, traffic = tiny(name)
    out = control.readings(ROOT, name, [5, 2**31 + 6, 77], "cpu",
                           config=config, traffic=traffic)
    assert out["sound_all_correct"]
    assert not out["control_any_correct"]


def _unchanged(run):
    # every step hands its state back as it found it
    def broken(batch, **kw):
        return batch, run(batch, max_steps=0)[1]
    return broken


def _half(run):
    # half of the lanes left out, filled in from the lanes that ran
    def broken(batch, **kw):
        from repro_torch.core.state import map_tensors
        n = batch.time.shape[0] // 2
        out, stats = run(map_tensors(lambda t: t[:n], batch), **kw)
        return map_tensors(lambda t: torch.cat([t, t]), out), stats
    return broken


def _altered(run):
    # one answer altered where it is produced: every lane's last
    # cloudlet finishes a minute late
    def broken(batch, **kw):
        out, stats = run(batch, **kw)
        cl = out.cloudlets
        ft = cl.finish_time.clone()
        ft[:, -1] += 60.0
        return dataclasses.replace(
            out, cloudlets=dataclasses.replace(cl, finish_time=ft)), stats
    return broken


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["unchanged", "half", "altered"])
def test_broken_run_is_not_correct(name, fault, monkeypatch):
    from repro_torch.core import engine
    monkeypatch.setattr(engine, "batched_run_stats",
                        fault(engine.batched_run_stats))
    out = run_tiny(name, 2**31 + 21)
    assert not out["correct"], out["checks"]
