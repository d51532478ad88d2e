"""Deploy an evolved approximate multiplier inside an LM, on the
PyTorch/CUDA port.

    python examples/approx_nn_inference_torch.py --registry /path/to/registry

The port's counterpart of ``examples/approx_nn_inference.py``.  Takes a
fingerprinted circuit artifact from the registry a sweep exported
(``launch.evolve --export-artifacts`` / ``python -m
repro_torch.launch.export``): its LUT is digest-verified and replayed from
its genome, then a small transformer runs with every projection matmul
routed through the emulated approximate arithmetic (``models/quant.py``,
the hand-written ``lut_matmul`` kernel on the card), reporting the
model-level degradation (perplexity) against exact fp32 and exact int8.
Without ``--registry`` / ``--artifact`` it evolves a fresh 8×8 multiplier
inline (slower; the circuit is neither certified nor registered).  The
tokens are the reference's (``random.randint`` from ``PRNGKey(0)``); the
weights are drawn from a seeded ``torch.Generator`` unless given.  Runs on
the card by default (and raises without one); ``--device cpu`` runs the
plain PyTorch path.
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models import quant

# the reference example's toy model
CONFIG = ModelConfig(name="toy", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=128, vocab=256)


def perplexity(params, toks, cfg) -> float:
    with torch.no_grad():
        return float(torch.exp(M.lm_loss(params, toks, toks, cfg)))


def evolve_inline(device):
    """Fallback: evolve an 8x8 multiplier here (short budget; use
    launch.evolve + the artifact registry for real runs)."""
    from repro_torch.core.evolve import EvolveConfig
    from repro_torch.core.fitness import ConstraintSpec
    from repro_torch.core.genome import CGPSpec, Genome
    from repro_torch.core.library import multiplier_lut
    from repro_torch.core.search import SearchConfig, run_search
    scfg = SearchConfig(width=8, n_n=400,
                        evolve=EvolveConfig(generations=600, lam=8))
    con = ConstraintSpec(mae=0.1, er=95.0, acc0=True)
    print(f"evolving 8x8 multiplier under {con.describe()} ...")
    rec, _ = run_search(scfg, con, seed=0, device=device)
    print(f"  feasible={rec.feasible} power_rel={rec.power_rel:.3f} "
          f"mae={rec.metrics[0]:.4f}% er={rec.metrics[2]:.1f}%")
    genome = Genome(torch.as_tensor(rec.genome_nodes),
                    torch.as_tensor(rec.genome_outs))
    lut = multiplier_lut(genome, CGPSpec(16, 16, 400))
    return lut, rec.power_rel, con.describe()


def main(argv=None, params: M.Transformer | None = None) -> dict:
    """Run the study; ``params`` replaces the seeded random weights."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--artifact", default=None,
                    help="registry artifact .npz to deploy (digest-verified "
                         "+ genome-replayed before use)")
    ap.add_argument("--registry", default=None,
                    help="registry directory; the lowest-power feasible "
                         "artifact is selected")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. the deployment artifact: registry-verified, or evolved inline
    if args.artifact or args.registry:
        from repro_torch.core.artifacts import resolve_artifact
        art = resolve_artifact(args.artifact or args.registry)
        lut, power_rel, constraint = art.lut, art.power_rel, art.constraint
        print(f"artifact {art.path}: {constraint} (seed {art.seed}, "
              f"power_rel={power_rel:.3f}, certified={art.certified}, "
              f"digest {art.digest[:12]}...)")
    else:
        lut, power_rel, constraint = evolve_inline(dev)

    exact = np.arange(256)[:, None] * np.arange(256)[None, :]
    print(f"  LUT mean |err| = {np.abs(lut - exact).mean():.2f} "
          f"(of max product 65025)")

    # 2. model-level impact
    cfg = CONFIG
    if params is None:
        params = M.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    params = params.to(dev)
    toks = R.randint(R.PRNGKey(0, dev), (args.batch, args.seq_len), 0,
                     cfg.vocab).to(torch.int64)

    ppl_fp = perplexity(params, toks, cfg)
    cfg_q = dataclasses.replace(cfg, approx_matmul=True)
    prev = quant._LUT
    try:
        quant.set_multiplier_lut(None)           # exact int8 baseline
        ppl_int8 = perplexity(params, toks, cfg_q)
        quant.set_multiplier_lut(lut)            # evolved approximate circuit
        ppl_approx = perplexity(params, toks, cfg_q)
    finally:
        quant.set_multiplier_lut(prev)

    print(f"\nperplexity  fp32:        {ppl_fp:.4f}")
    print(f"perplexity  exact-int8:  {ppl_int8:.4f} "
          f"(quantization cost {100 * (ppl_int8 / ppl_fp - 1):+.2f}%)")
    print(f"perplexity  approx-mult: {ppl_approx:.4f} "
          f"(total cost {100 * (ppl_approx / ppl_fp - 1):+.2f}%)")
    print(f"\n=> the evolved circuit at {power_rel:.2f}x power adds "
          f"{100 * (ppl_approx / ppl_int8 - 1):+.2f}% perplexity over "
          f"exact int8 arithmetic")
    return {"ppl_fp32": ppl_fp, "ppl_int8": ppl_int8,
            "ppl_approx": ppl_approx, "power_rel": power_rel,
            "constraint": constraint}


if __name__ == "__main__":
    main()
