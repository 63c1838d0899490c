#!/usr/bin/env python3
"""The controls of ``correct``: the plain reference put in the program's
place with one guarantee of the configuration broken, judged by the same
comparison as a run. Each has to come out not correct.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        [--reads N]

Each traffic kind's module under ``benchmark/jobs/`` holds its control,
``control(ctx)``, which returns the ``state`` and the window's result
that its ``verify`` judges. Prints one JSON line per seed with the
numbers compared and their limits. Runs on the host alone; the program
is not imported.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness.core import Context, Manifest  # noqa: E402


def run(root: str, workload: str, seed: int, reads=None,
        manifest=None) -> dict:
    man = manifest or Manifest(root)
    cell = man.cell(workload)
    config = man.config(cell["config"])
    if reads:
        config = dict(config, reads=int(reads))
    wl = man.workload(workload)
    job = man.job(wl["kind"])
    work = os.path.join(root, ".bench_work", f"control-{workload}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        ctx = Context(root=root, work=work, config=config, workload=wl,
                      seed=seed, seconds=0, trace=False, device=None,
                      torch=None, port=None)
        ctx.inputs = man.generator(config["generator"]).make(
            config, seed, work)
        got = job.control(ctx)
        checks = job.verify(ctx, got["state"], got["win"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"workload": workload, "seed": seed,
            "correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run a cell's control.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--reads", type=int, default=None)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for s in args.seeds.split(","):
        print(json.dumps(run(root, args.workload, int(s), args.reads)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
