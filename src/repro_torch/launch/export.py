"""Artifact-registry export CLI on the PyTorch port (evolve → LUT → serve).

Export per-constraint elite circuits of a sweep results directory as
fingerprinted LUT artifacts:

  PYTHONPATH=src python -m repro_torch.launch.export \
      --results-dir /shared/sweep-shards --out /shared/registry --top-k 1

Verify an existing registry (digests, genome → LUT replay, fingerprints):

  PYTHONPATH=src python -m repro_torch.launch.export --verify /shared/registry

Prints the same lines as ``repro.launch.export``; registries are
interchangeable between the two packages.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core import artifacts as A


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Export sweep elites as fingerprinted LUT artifacts "
                    "(core.artifacts), or verify an existing registry.")
    ap.add_argument("--results-dir",
                    help="sweep shard directory (core.results) to export "
                         "elites from")
    ap.add_argument("--out",
                    help="registry directory to write artifacts + "
                         "registry.json into")
    ap.add_argument("--top-k", type=int, default=1,
                    help="artifacts per constraint group (default: 1)")
    ap.add_argument("--require-certified", action="store_true",
                    help="only export rows whose metrics are exact-"
                         "certified")
    ap.add_argument("--verify", metavar="REGISTRY_DIR",
                    help="verify every artifact in an existing registry "
                         "instead of exporting (digest + genome replay + "
                         "fingerprint pinning)")
    args = ap.parse_args(argv)

    if args.verify:
        arts = A.verify_registry(args.verify)
        for art in arts:
            print(f"[export] OK {art.path}: {art.constraint} seed "
                  f"{art.seed} power_rel={art.power_rel:.4f} "
                  f"certified={art.certified} digest {art.digest[:12]}…")
        print(f"[export] registry {args.verify}: {len(arts)} artifact(s) "
              f"verified")
        return 0

    if not args.results_dir or not args.out:
        ap.error("--results-dir and --out are required (or use --verify)")
    policy = A.ExportPolicy(top_k=args.top_k,
                            require_certified=args.require_certified)
    registry = A.export_elites(args.results_dir, args.out, policy)
    for e in registry["artifacts"]:
        print(f"[export] {e['file']}: {e['constraint']} seed {e['seed']} "
              f"power_rel={e['power_rel']:.4f} certified={e['certified']}")
    print(f"[export] {len(registry['artifacts'])} artifact(s) -> "
          f"{args.out} (grid {registry['grid_fingerprint'][:12]}…)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
