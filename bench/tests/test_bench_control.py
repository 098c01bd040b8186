"""The control (the reference with fp8 products in the program's place)
comes out as not correct.  On the CPU at a test's size: its readings are
wider than the program's by far more than the factor of 3 a limit needs.
On the card (``-m gpu``, skipped without one) at the cell's own size, one
seed a cell with a short window: the program within each limit, the
control past one of them."""
import pytest
import torch

import run as bench_run

CELLS = ("yi-6b.chat", "deepseek-7b.docs", "yi-6b.train")
PAIRS = {"logit_gap": "control_gap", "loss_gap": "control_loss_gap",
         "grad_gap": "control_grad_gap", "delta_gap": "control_delta_gap"}


@pytest.mark.parametrize("name", CELLS)
def test_control_separates_at_test_size(cpu_run, name):
    _, rec = bench_run.run_cell(cpu_run(name, seconds=1.0, control=True))
    r = rec["readings"]
    assert any(r[c] > 3 * max(r[p], 1e-9) for p, c in PAIRS.items()
               if p in r)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_cell_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its own size")
    from benchcore.program import add_program_path

    add_program_path(bench_run.ROOT)
    ctx = bench_run.Context(bench_run.ROOT, name, 20240611, 8.0, False,
                            control=True)
    out, rec = bench_run.run_cell(ctx)
    assert out["correct"]
    limits = ctx.cell["check"]["limits"]
    r = rec["readings"]
    assert any(r[PAIRS[k]] > lim for k, lim in limits.items())
