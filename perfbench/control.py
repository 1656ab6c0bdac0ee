"""The readings the check's limits are set from (``limits/<cell>.json``,
``PERF.md``): for each seed, the cell's set-up steps as a run makes them,
then the numbers the check compares, read three ways:

``program``  the program's recorded outputs against the reference: what a
             sound run reads (the lower reading, over a dozen seeds);
``control``  the reference at the precision below the configuration's
             (``common.make_cast``: TF32 for float32, float8 for
             bfloat16 activations) in the program's place;
``half``     the reference learning from half of each batch's columns
             (a planted fault);

and for each, under ``<kind>_detail``: each step's loss and the worst
leaves by ``grad_gap``'s, ``change_gap``'s and, where the family compares
it, ``grad_dir_gap``'s measure (``checks.training_detail``).

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 [--out readings.jsonl]

Runs on the card (``--device cuda``, the default) at the cell's own
sizes; one JSON line a seed. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload, seed, kinds, device, overrides=None):
    from perfbench import bench, checks
    c = bench.prepare(workload, seed, device, overrides=overrides)
    t0 = time.perf_counter()
    bench.warm_up(c, 0)
    setup_s = time.perf_counter() - t0
    bench.free_program(c)
    program = c.setup.program_outputs()
    reference = c.setup.reference_outputs()
    out = {"seed": seed, "setup_s": setup_s}
    candidates = [("program", program)]
    candidates += [(kind, c.setup.candidate(kind)) for kind in kinds]
    for kind, candidate in candidates:
        out[kind] = c.setup.numbers(candidate, reference)
        out[kind + "_detail"] = checks.training_detail(candidate, reference)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    for path in (ROOT, os.path.join(ROOT, "src")):
        if path not in sys.path:
            sys.path.insert(0, path)
    from repro_torch import resolve_device
    device = str(resolve_device(args.device))
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds:
        kinds = ("control", "half") if seed in control else ()
        line = json.dumps({"workload": args.workload,
                           **readings(args.workload, seed, kinds, device)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
