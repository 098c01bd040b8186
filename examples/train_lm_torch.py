"""End-to-end training driver on the port: train a ~100M-param dense LM
for a few hundred steps with checkpointing + deterministic resume.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20

The ~100M-parameter llama-style config of ``examples/train_lm.py`` (the
deepseek-7b family scaled to 12 layers x 768), on the card unless
``--device cpu`` is given (there attention runs K1 and takes its
gradient through ``FlashAttentionFn``).  Demonstrates: the data pipeline,
AdamW + cosine schedule, gradient clipping, microbatching, remat, async
checkpoints, exact resume.
"""
import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs import registry as reg  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # ~100M params: 12L x 768 dense llama-style
    cfg100m = dataclasses.replace(
        get_arch("deepseek-7b"), name="deepseek-100m", n_layers=12,
        d_model=768, n_heads=12, n_kv_heads=12, d_head=64, d_ff=2048,
        vocab_size=32000)
    reg.ARCHS[cfg100m.name] = cfg100m
    n = cfg100m.param_count()
    print(f"training {cfg100m.name}: {n/1e6:.0f}M params, "
          f"{args.steps} steps, seq {args.seq_len}, batch {args.batch}, "
          f"on {args.device}")

    ckpt = tempfile.mkdtemp(prefix="lm100m_ckpt_")
    out = train(arch=cfg100m.name, steps=args.steps, reduced=False,
                seq_len=args.seq_len, batch=args.batch,
                ckpt_dir=ckpt, ckpt_every=50, num_microbatches=2,
                remat="full", log_every=10, device=args.device)
    print(f"\nfinal loss {out['final_loss']:.4f} "
          f"(start {out['losses'][0]:.4f}) in {out['wall_s']:.0f}s; "
          f"checkpoints in {ckpt}")
    assert out["final_loss"] < out["losses"][0]


if __name__ == "__main__":
    main()
