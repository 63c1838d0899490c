#!/usr/bin/env python3
"""Time the port's read phases for two checkouts in alternating turns on one GPU.

    python3 scripts/torch_phase_pairs.py --trees OLD,NEW [--pairs 3]

Each tree is the root of a checkout that holds ``disq_tpu_torch``. The
script synthesizes ``chip_smoke.py``'s BAM from the seed once (2,000,000
reads, 64 MiB splits), writes its coordinate-sorted CRAM with QS as
order-0 rANS once through NEW's port, and then runs one child process
per turn in the order OLD, NEW, NEW, OLD, OLD, NEW, ... Each child
imports the port from its own tree only, builds its kernels, and times
in this order, each phase ending in ``torch.cuda.synchronize()``:

    bam_read_s       ReadsStorage.make_default().split_size(64 << 20).read
    sort_write_s     write(ds, out, BaiWriteOption.ENABLE, sort=True)
    executor4_read_s the same read with .executor_workers(4)
    legacy_read_s    the same read under DISQ_TPU_TORCH_DEVICE_INFLATE=legacy
                     (kernel B4)
    cram_read_s      the CRAM read (kernel B3)
    cram_legacy_read_s  the CRAM read under DISQ_TPU_TORCH_DEVICE_RANS=legacy

and checks every read's count and flagstat against the generator. It
prints one JSON line per turn and, last, one JSON object with each
phase's seconds per tree in turn order. Work files go under ``.smoke/``
of the checkout that holds this script, removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ["inflate", "parse", "rans_simd", "rans", "inflate_legacy"]


def child(args) -> dict:
    sys.path.insert(0, args.tree)
    import torch

    import disq_tpu_torch as port
    from disq_tpu_torch.ops import cuda_build

    tree = os.path.realpath(args.tree)
    if not os.path.realpath(port.__file__).startswith(tree + os.sep):
        raise SystemExit(f"imported {port.__file__}, not the port of {tree}")
    want = json.load(open(args.want))
    torch.zeros(1, device="cuda")
    cuda_build.build(KERNELS)
    storage = port.ReadsStorage.make_default().split_size(args.split_size)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def held(ds, what):
        got = [ds.count(), ds.flagstat()]
        if got != [want["count"], want["flagstat"]]:
            raise SystemExit(f"{what}: count/flagstat {got} != {want}")

    if args.make_cram:
        ds = storage.read(args.bam)
        os.environ["DISQ_TPU_TORCH_CRAM_RANS_O1"] = "0"
        storage.write(ds.coordinate_sorted(), args.cram,
                      port.CraiWriteOption.ENABLE)
        return {"cram_bytes": os.path.getsize(args.cram)}
    res = {}
    ds, res["bam_read_s"] = timed(lambda: storage.read(args.bam))
    held(ds, "bam read")
    out = os.path.join(os.path.dirname(args.bam), "sorted.bam")
    _, res["sort_write_s"] = timed(lambda: storage.write(
        ds, out, port.BaiWriteOption.ENABLE, sort=True))
    del ds
    ex, res["executor4_read_s"] = timed(
        lambda: storage.executor_workers(4).read(args.bam))
    held(ex, "4-worker read")
    del ex
    os.environ["DISQ_TPU_TORCH_DEVICE_INFLATE"] = "legacy"
    lg, res["legacy_read_s"] = timed(lambda: storage.read(args.bam))
    del os.environ["DISQ_TPU_TORCH_DEVICE_INFLATE"]
    held(lg, "legacy read")
    del lg
    cr, res["cram_read_s"] = timed(lambda: storage.read(args.cram))
    held(cr, "cram read")
    del cr
    os.environ["DISQ_TPU_TORCH_DEVICE_RANS"] = "legacy"
    cr, res["cram_legacy_read_s"] = timed(lambda: storage.read(args.cram))
    held(cr, "legacy cram read")
    return res


def run_child(tree: str, args, files: dict, make_cram: bool = False) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--child", "--tree", tree,
           "--split-size", str(args.split_size), *(f"--{k}={v}" for k, v in files.items())]
    if make_cram:
        cmd.append("--make-cram")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", help="OLD,NEW: checkout roots")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--records", type=int, default=2_000_000)
    ap.add_argument("--split-size", type=int, default=64 << 20)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--make-cram", action="store_true", help=argparse.SUPPRESS)
    for k in ("tree", "bam", "cram", "want"):
        ap.add_argument(f"--{k}", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args)), flush=True)
        return 0

    sys.path.insert(0, HERE)
    import chip_smoke

    old, new = (os.path.abspath(t) for t in args.trees.split(","))
    work = os.path.join(HERE, ".smoke", "pairs")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        files = {"bam": os.path.join(work, "in.bam"),
                 "cram": os.path.join(work, "sorted.cram"),
                 "want": os.path.join(work, "want.json")}
        g = chip_smoke.synthesize(args.records, args.seed)
        chip_smoke.write_bam(files["bam"], g, args.records)
        with open(files["want"], "w") as f:
            json.dump({"count": args.records,
                       "flagstat": chip_smoke.numpy_flagstat(g["flag"])}, f)
        del g
        print(json.dumps(run_child(new, args, files, make_cram=True)), flush=True)
        print(chip_smoke.card_line(), flush=True)
        turns = {old: [], new: []}
        for p in range(args.pairs):
            for tree in ((old, new) if p % 2 == 0 else (new, old)):
                res = run_child(tree, args, files)
                turns[tree].append(res)
                print(json.dumps({"tree": tree, **res}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phases = list(turns[new][0])
    print(json.dumps({name: {phase: [t[phase] for t in turns[tree]]
                             for phase in phases}
                      for name, tree in (("old", old), ("new", new))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
