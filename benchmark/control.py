#!/usr/bin/env python3
"""The control of the comparison that decides `correct`, and the program's
readings over many seeds, at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 10

For each seed, in one process: the cell's set-up and a window of
`--seconds` as benchmark/run.py runs them, then the numbers compared, read
twice on the same calls: for the program's answers, and for the plain
reference computed in float32 put in the program's place (the control).
The contig numbers are read a third time with each fault of an assembly's
output put into the window's contigs (benchlib/judge.py:CONTIG_FAULTS).
One JSON line a seed, and a last line with the largest program reading,
the smallest control reading and the smallest reading of each fault, of
each number. The benchmark's own runs do not run this. Needs a card.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def readings_for_seed(name, seed, seconds, device):
    from benchlib import harness, hooks, manifest

    man = manifest.manifest()
    entry = manifest.workload(man, name)
    cell = manifest.cell_file(name)
    config = manifest.config_file(man, entry["config"])
    patches = hooks.Patches()
    ctx = harness.Context(name, entry, cell, config, seed, False, device, patches)
    try:
        hooks.Spans(patches, annotate=False)
        driver = manifest.load_module("drivers", cell["driver"]).Driver(ctx)
        driver.setup()
        window_s, unit_s, failed, _ = harness.run_window(driver, seconds, False, device)
    finally:
        patches.restore()
    driver.release()
    program = driver.judge(control=False, faults=True)
    faults = program.pop("faults", {})
    control = driver.judge(control=True)
    return {"seed": seed, "units": len(unit_s), "unit_seconds": unit_s, "failed": failed,
            "window_s": window_s,
            "program": program, "control": control, "faults": faults}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch

    from benchlib import harness, judge, manifest

    entry = manifest.workload(manifest.manifest(), args.workload)
    problem = harness.check_cards(int(entry["chips"]))
    if problem:
        print(f"control: {problem}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = readings_for_seed(args.workload, seed, args.seconds, device)
        row["card"] = harness.card_line()
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows)}
    for name in judge.VERIFY_NUMBERS + ("score_rel_gap",) + judge.CONTIG_NUMBERS:
        prog = [r["program"][name] for r in rows if name in r["program"]]
        ctrl = [r["control"][name] for r in rows if name in r["control"]]
        fault = {f: min(r["faults"][f][name] for r in rows) for f in judge.CONTIG_FAULTS
                 if rows and all(name in r["faults"].get(f, {}) for r in rows)}
        summary[name] = {"program_max": max(prog) if prog else None,
                         "control_min": min(ctrl) if ctrl else None}
        if fault:
            summary[name]["fault_min"] = fault
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
