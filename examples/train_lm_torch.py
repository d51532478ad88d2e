"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-parameter
dense LM for a few hundred steps on the synthetic corpus, with checkpoints
and auto-resume.

    python examples/train_lm_torch.py [--steps 300] [--tiny] [--device cpu]

The port's counterpart of ``examples/train_lm.py``: a llama-style model of
d512 × 8 layers and a 32k vocabulary (``--tiny``: ``llama3_2_1b``'s
reduced configuration, 30 steps, for tests).  Runs on the card by default
(and raises without one); ``--device cpu`` runs the plain PyTorch path.
Rerunning with the same ``--ckpt-dir`` resumes from its newest step.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.train import train

# ~100M parameters, llama-style
CONFIG_100M = ModelConfig(
    name="llama-100m", family="dense", n_layers=8, d_model=512, n_heads=8,
    n_kv_heads=4, head_dim=64, d_ff=2048, vocab=32000, tie_embeddings=True,
    rope_theta=500000.0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain path)")
    args = ap.parse_args(argv)

    if args.tiny:
        out = train("llama3_2_1b", steps=min(args.steps, 30), batch=4,
                    seq=64, reduced=True, ckpt_dir=args.ckpt_dir,
                    ckpt_every=10, device=args.device)
    else:
        out = train("llama3_2_1b", steps=args.steps, batch=8, seq=256,
                    reduced=True, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                    microbatches=2, device=args.device, config=CONFIG_100M)
    losses = out["losses"]
    if not losses:
        print(f"\n{args.ckpt_dir} already holds step {out['steps']}: "
              f"nothing to train")
        return out
    print(f"\nloss: first={losses[0]:.3f} last={losses[-1]:.3f} "
          f"({out['wall_s']:.0f}s total)")
    assert losses[-1] < losses[0], "loss did not decrease"
    print("training loss decreased — OK")
    return out


if __name__ == "__main__":
    main()
