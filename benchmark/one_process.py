#!/usr/bin/env python3
"""A sample of a cell that spans ranks, run again in one process with no
process group: the reference of the distribution's semantics.

    python3 benchmark/one_process.py --workload savage-sample-4rank.abc --seed <n> --units 0,1

draws units k of the seed's pool as the cell does and runs the cell
driver's `run_sample` on each in this process, on one card (card 0 unless
CUDA_VISIBLE_DEVICES names another; the CPU with HC_TORCH_DEVICE=cpu).
Prints one JSON line a unit with the SHA-256 of its final contigs (benchlib/ranks.py:contig_digest), which must equal
`sample_sha256[k]` of a run of the cell on the same seed (a window's
unit k is unit k of the pool while k is less than the pool). The
benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", default="0", help="comma-separated pool indices")
    args = ap.parse_args(argv)
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    from benchlib import manifest, ranks
    from benchlib.assembly import unit_store
    from benchlib.simulate import draw_unit

    man = manifest.manifest()
    entry = manifest.workload(man, args.workload)
    cell = manifest.cell_file(args.workload)
    config = manifest.config_file(man, entry["config"])
    driver = manifest.load_module("drivers", cell["driver"])
    shapes = driver.sample_shapes(config)
    for k in (int(u) for u in args.units.split(",")):
        store = unit_store(draw_unit(args.seed, cell["stream"], k, shapes))
        t0 = time.perf_counter()
        final, timings = driver.run_sample(store, config["savage"])
        print(json.dumps({"workload": args.workload, "seed": args.seed, "unit": k,
                          "reads": len(store), "seconds": time.perf_counter() - t0,
                          "sha256": ranks.contig_digest(*final), "timings": timings}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
