"""CGP approximation launcher on the PyTorch/CUDA port — the paper's
experiment as a CLI.

  PYTHONPATH=src python -m repro_torch.launch.evolve --width 8 \
      --constraint "mae=0.5,er=60" --generations 2000 --seeds 3 \
      --out experiments/lib/mae05_er60.json

Runs on the card; ``--device cpu`` runs the plain PyTorch path instead.
Prints the same ``[evolve] … runs/s`` line and JSON rows as
``repro.launch.evolve``, and ``--out`` writes the same circuit library.
``--results-dir`` streams one result shard per chunk and
``--checkpoint-dir`` checkpoints the sweep: rerun the same command to
resume an interrupted sweep (a finished one reports ``@ 0.00 runs/s``).
``--export-artifacts DIR`` then exports the elites as a LUT registry that
``repro_torch.launch.serve --approx-lut DIR`` serves:

  PYTHONPATH=src python -m repro_torch.launch.evolve --width 8 \
      --constraint "mae=0.5,er=60" --generations 2000 --seeds 16 \
      --results-dir R --history summary --export-artifacts REG

Past width ~10 the exhaustive cube is out of reach: ``--eval-mode sampled``
scores candidates on a deterministic operand sample (``--sample-size``,
``--input-dist``, ``--sample-seed``) and prints each record's standard
errors; ``--certify`` re-measures the best sampled-feasible elites of each
chunk exactly over the whole cube and prints which rows are certified:

  PYTHONPATH=src python -m repro_torch.launch.evolve --width 12 \
      --nodes 768 --constraint "mae=0.5,er=60" --constraint "wce=2.0" \
      --seeds 16 --lam 8 --eval-mode sampled --sample-size 16384 \
      --certify --certify-budget 8 --results-dir R

The sweep engine's execution knobs: ``--dedup`` evaluates each unique
active subgraph once (the runs are the same); ``--pods N --pod-index I``
runs pod I's slice of the chunk plan into a shared ``--results-dir`` (one
process per pod); ``--async-commit`` writes shards and checkpoints on a
background thread (the same bytes); ``--migrate-every K`` publishes each
pod's elites every K chunks and folds the other pods' into later chunks
(this changes the results and the grid fingerprint):

  PYTHONPATH=src python -m repro_torch.launch.evolve --width 8 \
      --constraint "mae=0.5,er=60" --seeds 64 --dedup --async-commit \
      --pods 2 --pod-index 0 --migrate-every 1 --results-dir R
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.evolve import EvolveConfig
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.library import save_library
from repro_torch.core.metrics import METRIC_NAMES
from repro_torch.core.search import SearchConfig, run_sweep_serial
from repro_torch.core.sweep import SweepConfig, run_sweep_batched


def parse_constraint(s: str) -> ConstraintSpec:
    kw = {}
    for part in s.split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        k = k.strip()
        if k in ("acc0", "gauss"):
            kw[k] = v.strip().lower() in ("1", "true", "yes", "")
        else:
            kw[k] = float(v)
    return ConstraintSpec(**kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--kind", default="mul", choices=["mul", "add"])
    ap.add_argument("--nodes", type=int, default=400)
    ap.add_argument("--constraint", action="append", required=True,
                    help='e.g. "mae=0.5,er=60" (repeatable)')
    ap.add_argument("--generations", type=int, default=2000)
    ap.add_argument("--lam", type=int, default=8)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--chunk-size", type=int, default=32,
                    help="runs evaluated together (one kernel launch per "
                         "generation for chunk x lambda genomes)")
    ap.add_argument("--history", default=None,
                    choices=["full", "summary", "none"],
                    help="per-generation parent histories: in RAM and in "
                         "the shards ('full', the default), in the "
                         "--results-dir shards only ('summary'), or nowhere "
                         "('none')")
    ap.add_argument("--no-history", action="store_true",
                    help="alias for --history none")
    ap.add_argument("--results-dir", default=None,
                    help="stream each finished chunk to an on-disk result "
                         "shard (core.results; readable by either package); "
                         "the shard set is resumable: rerun to continue")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="resumable sweep state; rerun with the same grid "
                         "to continue mid-grid")
    ap.add_argument("--out", default=None,
                    help="write the records as a JSON circuit library "
                         "(core.library)")
    ap.add_argument("--export-artifacts", default=None, metavar="DIR",
                    help="after the sweep, export per-constraint elite "
                         "circuits from --results-dir as fingerprinted LUT "
                         "artifacts + registry.json into DIR, the input of "
                         "`serve --approx-lut`")
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "genome_major", "cube_major"],
                    help="cgp_sim kernel variant: genome_major reads the "
                         "input cube from device memory per genome, "
                         "cube_major stages each run of the cube in shared "
                         "memory and walks a group of genomes over it; auto "
                         "resolves the measured tuning table "
                         "(kernels/tune.py).  The runs are the same either "
                         "way")
    ap.add_argument("--dedup", action="store_true",
                    help="phenotype-dedup evaluation cache: evaluate each "
                         "unique active subgraph once per generation and "
                         "reuse cached results across generations.  "
                         "Execution-only: the runs are the same with or "
                         "without it")
    ap.add_argument("--dedup-cache-size", type=int, default=1 << 16,
                    help="entry bound of the cross-generation phenotype LRU "
                         "(default: 65536)")
    ap.add_argument("--eval-mode", default="exhaustive",
                    choices=["exhaustive", "sampled"],
                    help="evaluation inputs: 'exhaustive' scores every "
                         "candidate on the full 2^(2w) cube; 'sampled' on a "
                         "deterministic --sample-size operand sample from "
                         "--input-dist, with per-metric standard errors "
                         "reported (the only tractable mode past width "
                         "~10-12)")
    ap.add_argument("--sample-size", type=int, default=1 << 14,
                    help="rows per sample (eval-mode=sampled); rounded up "
                         "to a power-of-two word count x 32 lanes "
                         "(default: 16384)")
    ap.add_argument("--input-dist", default="uniform",
                    choices=["uniform", "gaussian", "empirical"],
                    help="operand distribution of the sample: uniform over "
                         "[0, 2^w); gaussian centered mid-range (sigma = "
                         "2^w/6, clipped); or empirical, inverse-CDF draws "
                         "from a histogram of the synthetic data stream")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="seed of the counter-based sample stream (part of "
                         "the grid fingerprint)")
    ap.add_argument("--certify", action="store_true",
                    help="exact tier: after each sampled sweep chunk, the "
                         "best elites that satisfy the combined constraint "
                         "on the sample are re-measured exactly over the "
                         "full 2^(2w) cube, so their WCE/ACC0/GAUSS verdicts "
                         "are guarantees, not estimates.  No-op under "
                         "--eval-mode exhaustive (a census is exact)")
    ap.add_argument("--certify-budget", type=int, default=8,
                    help="base escalations per sweep chunk; the cap ramps "
                         "to twice that by the last chunk (default: 8)")
    ap.add_argument("--pods", type=int, default=1,
                    help="pod-shard the sweep: partition the chunk plan "
                         "over N pods and run only this process's slice "
                         "(launch once per pod with a shared --results-dir)")
    ap.add_argument("--pod-index", type=int, default=None,
                    help="which pod slice this process runs (default: the "
                         "active mesh's pod coordinate, else the "
                         "torch.distributed rank, else 0)")
    ap.add_argument("--async-commit", action="store_true",
                    help="commit result shards / checkpoints on a bounded "
                         "background thread so the next chunk runs while "
                         "the previous one's npz write + fsync runs.  "
                         "Execution-only: the committed bytes, their order "
                         "and the crash guarantees are the synchronous "
                         "path's")
    ap.add_argument("--migrate-every", type=int, default=0,
                    help="island-model elite migration between pods: every "
                         "N chunks of its own slice a pod publishes its "
                         "per-sigma elite genomes to --results-dir, and "
                         "later chunks fold the pods' published elites into "
                         "their initial population under a deterministic "
                         "merge rule.  Changes the results (joins the grid "
                         "fingerprint when on); 0 disables (default)")
    ap.add_argument("--migrate-timeout", type=float, default=120.0,
                    help="seconds to wait for a lagging pod's migrant file "
                         "before failing (default: 120)")
    ap.add_argument("--serial", action="store_true",
                    help="reference serial loop instead of the batched engine")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the hand-written kernel) or 'cpu' "
                         "(the plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.pods > 1 and not args.results_dir:
        ap.error("--pods > 1 needs a shared --results-dir (the shard set "
                 "is the only cross-pod resume state)")
    if args.serial and args.pods > 1:
        ap.error("--serial is the single-process reference loop; it cannot "
                 "pod-shard the grid (drop --serial or --pods)")
    if args.serial and args.dedup:
        ap.error("--dedup lives in the batched sweep engine; drop --serial")
    if args.serial and args.certify:
        ap.error("--certify's escalation driver lives in the batched sweep "
                 "engine; drop --serial")
    if args.serial and args.async_commit:
        ap.error("--async-commit's background committer lives in the "
                 "batched sweep engine; drop --serial")
    if args.serial and args.migrate_every:
        ap.error("--migrate-every lives in the batched sweep engine; drop "
                 "--serial")
    if args.migrate_every and not args.results_dir:
        ap.error("--migrate-every needs a --results-dir: migrant files "
                 "ride the shared results directory (DESIGN.md section 11)")
    if args.export_artifacts and (args.serial or not args.results_dir):
        ap.error("--export-artifacts reads the sweep back from its result "
                 "shards: it needs --results-dir and the batched engine")
    if args.export_artifacts and args.kind != "mul":
        ap.error("--export-artifacts builds multiplier LUT artifacts; "
                 "--kind add is not exportable")

    cfg = SearchConfig(
        width=args.width, kind=args.kind, n_n=args.nodes,
        evolve=EvolveConfig(generations=args.generations, lam=args.lam,
                            layout=args.layout, eval_mode=args.eval_mode,
                            sample_size=args.sample_size,
                            input_dist=args.input_dist,
                            sample_seed=args.sample_seed,
                            certify=args.certify,
                            certify_budget=args.certify_budget))
    constraints = [parse_constraint(c) for c in args.constraint]
    if args.serial:
        records = run_sweep_serial(cfg, constraints, seeds=range(args.seeds),
                                   device=args.device)
    else:
        pod = args.pod_index
        if args.pods > 1 and pod is None:
            # resolved once here, so the printed label and the slice run
            # cannot disagree
            from repro_torch.parallel import ctx
            pod = ctx.default_pod_index(args.pods)
        result = run_sweep_batched(
            cfg, constraints, seeds=range(args.seeds),
            sweep=SweepConfig(chunk_size=args.chunk_size,
                              checkpoint_dir=args.checkpoint_dir,
                              keep_history=args.history or (
                                  "none" if args.no_history else "full"),
                              results_dir=args.results_dir,
                              layout=args.layout, n_pods=args.pods,
                              pod_index=pod, dedup=args.dedup or None,
                              dedup_cache_size=args.dedup_cache_size,
                              async_commit=args.async_commit,
                              migrate_every=args.migrate_every,
                              migrate_timeout=args.migrate_timeout),
            device=args.device)
        records = result.records
        tag = f"pod {pod}/{args.pods}: " if args.pods > 1 else ""
        print(f"[evolve] {tag}{result.completed}/{result.n_runs} runs "
              f"@ {result.runs_per_sec:.2f} runs/s", flush=True)
        if args.certify and result.certify_stats is not None:
            st = result.certify_stats
            print(f"[evolve] certify: {st['escalated']} escalations this "
                  f"call, {st['certified_rows']}/{result.n_runs} rows "
                  f"certified exact (budget {st['budget']}/chunk)",
                  flush=True)
        if args.migrate_every and result.migrate_stats is not None:
            st = result.migrate_stats
            print(f"[evolve] migrate: {st['published']} epochs published, "
                  f"{st['imported']} elites imported, {st['adopted']} runs "
                  f"adopted a migrant ({st['waited_s']:.1f}s waiting on "
                  f"peers)", flush=True)
        if args.dedup and result.dedup_stats is not None:
            st = result.dedup_stats
            print(f"[evolve] dedup cache: hit rate {st['hit_rate']:.1%} "
                  f"({st['evaluated']}/{st['candidates']} candidates "
                  f"evaluated, {st['lru_hits']} LRU hits, "
                  f"{st['evictions']} evictions)", flush=True)
        if args.results_dir:
            reader = result.reader()
            print(f"[evolve] {len(reader.spans())} result shards "
                  f"({reader.completed}/{reader.n_runs} runs, history mode "
                  f"{reader.keep_history!r}) -> {args.results_dir}",
                  flush=True)
    for r in records:
        met = {n: round(float(v), 4) for n, v in zip(METRIC_NAMES, r.metrics)}
        row = {"constraint": r.constraint, "seed": r.seed,
               "power_rel": round(r.power_rel, 4),
               "feasible": r.feasible, "metrics": met}
        if args.eval_mode == "sampled":
            row["metrics_stderr"] = {
                n: round(float(v), 6)
                for n, v in zip(METRIC_NAMES, r.metrics_stderr)}
            if args.certify:
                row["certified"] = r.certified
        print(json.dumps(row), flush=True)
    if args.out:
        save_library(records, args.out)
        print(f"[evolve] wrote {len(records)} circuits -> {args.out}")
    if args.export_artifacts:
        from repro_torch.core.artifacts import export_elites
        registry = export_elites(args.results_dir, args.export_artifacts)
        print(f"[evolve] exported {len(registry['artifacts'])} LUT "
              f"artifact(s) -> {args.export_artifacts} "
              f"(grid {registry['grid_fingerprint'][:12]}...)", flush=True)


if __name__ == "__main__":
    main()
