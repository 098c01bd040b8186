"""Each fault a cell can have (``benchcore.faults``), planted under the
timed path, makes a whole run come out as not correct; the same run
without it is correct.  The runs skip the harness's look for a card and
drive the port's CPU route at a test's size (see conftest)."""
import pytest

import run as bench_run
from benchcore import faults

SERVE = ("yi-6b.chat", "deepseek-7b.docs")


def _correct(cpu_run, name, fault=None):
    undo = faults.ALL[fault]() if fault else None
    try:
        out, _ = bench_run.run_cell(cpu_run(name, seconds=1.0))
    finally:
        if undo:
            undo()
    return out["correct"]


@pytest.mark.parametrize("name", SERVE + ("yi-6b.train",))
def test_sound_run_is_correct(cpu_run, name):
    assert _correct(cpu_run, name)


@pytest.mark.parametrize("name, fault", [
    (name, fault) for name in SERVE for fault in sorted(faults.SERVING)])
def test_serving_fault_is_not_correct(cpu_run, name, fault):
    assert not _correct(cpu_run, name, fault)


@pytest.mark.parametrize("fault", sorted(faults.TRAINING))
def test_training_fault_is_not_correct(cpu_run, fault):
    assert not _correct(cpu_run, "yi-6b.train", fault)
