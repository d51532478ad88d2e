"""Run one of ``chip_smoke.py``'s later phases alone on the card.

  python3 tools/chip_phases.py flash
  python3 tools/chip_phases.py dense
  python3 tools/chip_phases.py ssm
  python3 tools/chip_phases.py multi
  python3 tools/chip_phases.py tp
  python3 tools/chip_phases.py mixers
  python3 tools/chip_phases.py hd
  python3 tools/chip_phases.py heads
  python3 tools/chip_phases.py ep_train --seqs 256,4096
  python3 tools/chip_phases.py tooling
  python3 tools/chip_phases.py figures [--width 6 --gens 300]
  python3 tools/chip_phases.py figures_pass --out-dir D --width 8 \
      --gens 1200 --seeds 3

Builds the three kernels (one nvcc each, started together), installs
nothing else, and calls the phase with the exact product table as its LUT
(the elite's table comes from the sweep of phase 4, which this skips).
Prints what the phase prints, the card line and the phase's seconds.
Phases: ``flash`` (9, flash_attention against its plain version, with
the build's ptxas report); ``dense`` (16, the dense configurations
served: on the exact table phi4-mini's two attention paths part by more
than the logits limit, which was set on the elite's table); ``ssm``
(18's SSM configuration, mamba2-1.3b, served); ``multi`` (22, the
multi-device LM); ``tp`` (22 (e), tensor-parallel serving, then 23 (b'),
its fake world's dry run against rank 0's counts); ``mixers`` (22 (f) and
(g), the SSM mixer and cross-attention tensor-parallel: mamba2-1.3b and
llama3.2-vision-11b served, mamba2 trained); ``hd`` (22 (h), the decode
on a head_dim-split cache: llama3.2-1b on (data 1, model 16), 16 gloo
ranks on the card); ``heads`` (22 (i), the blocks whose dims do not
divide over 16 ranks: phi4-mini's head groups and mamba2's d_model-split
table, served, and phi4-mini trained, on (data 1, model 16)); ``tooling``
(23, the
dry run and the roofline against the card); ``figures`` (24, the paper's figure
pipeline: ``--width`` / ``--gens`` set (b)'s width and generations);
``figures_pass`` (24 (b) alone into ``--out-dir``, kept: the figure
JSONs, ``claims_summary.json`` and the grids' shards, at ``--width``,
``--gens`` and ``--seeds``, default the reference's budget);
``ep_train`` (22 (b)'s training alone at batch 2 and each of ``--seqs``:
the one-rank runs with the single-device MoE and with EP's combine, then
EP on (data 1, model 2), each length's distances printed, a length
outside the limit too).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402


def ep_train(device, tmp, lut, args) -> None:
    """22 (b)'s training alone at batch 2 and each of ``args.seqs``."""
    for seq in (int(x) for x in args.seqs.split(",")):
        shape = (CS.MULTI_EP_TRAIN[0], seq, CS.MULTI_EP_TRAIN[2])
        one = CS.multi_ep_train(device, shape=shape)
        CS.free_card()
        ranks = CS.multi_ranks(CS.multi_ep_train_rank, device, shape)
        try:
            CS.log(CS.multi_ep_train_line(CS.multi_ep_train_check(
                one, ranks, shape[2]), shape))
        except AssertionError as e:
            CS.log(f"[multi] (b) EP train, batch {shape[0]} x {seq}, "
                   f"outside the limit: {e}")


def tp(device, tmp, lut, args) -> None:
    """22 (e) alone, then 23 (b') against its rank 0's counts."""
    one = CS.multi_tp_run(device, lut)
    CS.free_card()
    ranks = CS.multi_ranks(CS.multi_tp_rank, device, lut)
    e = CS.multi_report_e(one, ranks, device, lut)
    dry = CS.tool_workers((("tp", device),))[("tp", device)]["prefill"]
    CS.tool_tp_check(dry, CS.tp_counts(e))


def figures(device, tmp, lut, args) -> None:
    """Phase 24 alone, (b) at ``args.width`` / ``args.gens`` if given."""
    w, g, s = CS.FIG_DEPTH
    CS.phase_figures(device, tmp, (args.width or w, args.gens or g, s))


def figures_pass(device, tmp, lut, args) -> None:
    """Phase 24 (b) alone into ``args.out_dir``, at the reference's budget
    unless the flags say otherwise."""
    if not args.out_dir:
        raise SystemExit("figures_pass needs --out-dir")
    CS.figures_depth(device, args.out_dir,
                     (args.width or 6, args.gens or 1200, args.seeds or 3))


PHASES = {"flash": lambda device, tmp, lut, args:
          CS.phase_flash(device, args.build_logs["flash_attention"]),
          "dense": lambda device, tmp, lut, args:
          CS.phase_serve_dense(device, lut),
          "ssm": lambda device, tmp, lut, args:
          CS.phase_serve_ssm(device, lut),
          "multi": lambda device, tmp, lut, args:
          CS.phase_multi(device, tmp, lut),
          "ep_train": ep_train,
          "tp": tp,
          "mixers": lambda device, tmp, lut, args:
          CS.phase_multi_mixers(device, lut),
          "hd": lambda device, tmp, lut, args:
          CS.phase_multi_hd(device, lut),
          "heads": lambda device, tmp, lut, args:
          CS.phase_multi_heads(device, lut),
          "figures": figures,
          "figures_pass": figures_pass,
          "tooling": lambda device, tmp, lut, args:
          CS.phase_tooling(device, lut)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phase", choices=sorted(PHASES))
    ap.add_argument("--seqs", default=str(CS.MULTI_EP_TRAIN[1]),
                    help="ep_train: sequence lengths, comma-separated")
    ap.add_argument("--width", type=int, default=None,
                    help="figures: (b)'s width")
    ap.add_argument("--gens", type=int, default=None,
                    help="figures: (b)'s generations")
    ap.add_argument("--seeds", type=int, default=None,
                    help="figures_pass: seeds")
    ap.add_argument("--out-dir", default=None,
                    help="figures_pass: where the pass's files go")
    args = ap.parse_args()
    sys.path.insert(0, CS.SRC)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        CS.log("chip_phases: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import cgp_sim, flash_attention, lut_matmul
    modules = (cgp_sim, lut_matmul, flash_attention)
    with ThreadPoolExecutor(len(modules)) as pool:
        infos = list(pool.map(lambda m: m.build(), modules))
    args.build_logs = {m.__name__.rsplit(".", 1)[-1]: info.log
                       for m, info in zip(modules, infos)}
    a = np.arange(256, dtype=np.int32)
    lut = a[:, None] * a[None, :]
    CS.log(CS.card_line())
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_phases_") as tmp:
        PHASES[args.phase]("cuda", tmp, lut, args)
    CS.log(f"[time] {args.phase} {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
