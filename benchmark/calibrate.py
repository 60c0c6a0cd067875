"""Readings of a cell's control and faults, from which its limits are set.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--fault half | --program [--seconds S]]

on the machine the cell runs on. A sampling cell: the plain reference put
in the program's place in the configuration's ``control_formats`` (the
precision below the stated one), through the cell's own requests at its
own sizes, judged as a run judges. The training cell: the reference's
first steps in the control's format, or with ``--fault half`` (half of
every batch left out, the mean over the rest), against the float32
reference. ``--program``: the program's own readings, from whole runs of
``--seconds`` each, one process for every seed. One JSON line a seed: the
numbers compared and their limits. The benchmark's runs never do this.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None):
    import argparse
    import json

    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("half",), default=None)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    spec = harness.Spec(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        if args.program:
            out, run = harness.execute(spec, seed, args.seconds, False,
                                       args.device)
            checks = run.checks
        elif spec.workload["driver"] == "train":
            from benchmark.drivers import train

            ref = train.reference_steps(spec.config, spec.workload, seed,
                                        args.device)
            fmt = "float32" if args.fault else spec.config[
                "control_formats"][0]
            got = train.reference_steps(spec.config, spec.workload, seed,
                                        args.device, fmt, args.fault)
            run = None
            checks = train.compare(*got, *ref, w0=train.make_weights(
                spec.config, train.derive_seed(seed, 10), args.device)[0],
                lim=spec.workload["limits"])
        else:
            _, run = harness.execute(spec, seed, 0.0, False, args.device,
                                     control=True)
            checks = run.checks
        reading = "program" if args.program else args.fault or "control"
        info = run.info if run is not None else {}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": reading, "info": info,
                          "seconds": time.perf_counter() - t,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in checks.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
