"""The plain reference against the port's CPU route at a test's size, on
the benchmark's own weights: the logits of a whole sequence, and (through
a whole training run of the cell) each checked step."""
import torch

from benchcore import spec
from benchcore.program import port_config, small_conf
from benchcore.weights import dims, make_weights
from reference.llama import served_logits


def test_reference_logits_match_the_port():
    from repro_torch.models import build_model

    small, over = small_conf(spec.load_config("deepseek-7b"), layers=3)
    model = build_model(port_config(small, over))
    w = make_weights(small, 11, "cpu", torch.float32)
    toks = torch.randint(0, small["vocab_size"], (1, 40),
                         generator=torch.Generator().manual_seed(3))
    hidden, _ = model.forward(w, toks)
    port = model.head_logits(w, hidden)[0]
    ref = served_logits(w, dims(small), [toks[0].tolist()],
                        [list(range(40))])[0]
    assert torch.allclose(port, ref, atol=1e-4, rtol=1e-4)


def test_training_reference_follows_the_port(cpu_run):
    import run as bench_run

    out, rec = bench_run.run_cell(cpu_run("yi-6b.train", seconds=0.5))
    r = rec["readings"]
    assert out["correct"]
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-4 \
        and r["delta_gap"] < 1e-4
