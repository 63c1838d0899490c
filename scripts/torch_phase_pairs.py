#!/usr/bin/env python3
"""Time the port's read phases for two checkouts in alternating turns on one GPU.

    python3 scripts/torch_phase_pairs.py --trees OLD,NEW [--pairs 3]
                                         [--phases executor4_read_s,...]

Each tree is the root of a checkout that holds ``disq_tpu_torch``. The
script synthesizes ``chip_smoke.py``'s BAM from the seed once (2,000,000
reads, 64 MiB splits), writes its coordinate-sorted CRAM with QS as
order-0 rANS once through NEW's port, and then runs one child process
per turn in the order OLD, NEW, NEW, OLD, OLD, NEW, ... It also
writes a copy of the CRAM with one byte flipped mid-payload in a
container of split 2 (``chip_smoke.flip_cram_container``). Each child
imports the port from its own tree only, builds its kernels, and times
in this order, each phase ending in ``torch.cuda.synchronize()``:

    parse_device_ms  kernel B2 at split 0's shape (its records in the
                     split's blob, inflated on the host), device time per
                     launch from torch.profiler; parse_graph_ms the same
                     from a CUDA graph of 20 launches, parse_wrapper_ms
                     through the wrapper (chip_smoke.py's helpers, this
                     script's checkout, for both trees); parse_floor_ms
                     the same gather with no parse (GATHER_FLOOR below:
                     each record's 3 aligned 16-byte vectors read, 12
                     words stored), what this access pattern costs
    bam_read_s       ReadsStorage.make_default().split_size(64 << 20).read
    sort_write_s     write(ds, out, BaiWriteOption.ENABLE, sort=True)
    executor4_read_s the same read with .executor_workers(4)
    legacy_read_s    the same read under DISQ_TPU_TORCH_DEVICE_INFLATE=legacy
                     (kernel B4)
    cram_write_s     the single-file CRAM write, with its CRAI, of the
                     first 200,000 coordinate-sorted reads (QS as order-0
                     rANS), checked by a re-read
    cram_read_s      the CRAM read (kernel B3)
    cram_executor4_read_s  the CRAM read with .executor_workers(4)
    cram_skip_read_s, cram_quarantine_read_s  (phase cram_policy_reads)
                     the flipped copy's read with .error_policy("skip" /
                     "quarantine"); null for a tree whose CRAM read
                     raises there (it ignores the policy)
    cram_legacy_read_s  the CRAM read under DISQ_TPU_TORCH_DEVICE_RANS=legacy

and checks every read's count and flagstat against the generator (the
policy reads against its records outside the flipped container).
``--phases`` runs only the named phases (``parse`` for the four
``parse_*`` numbers); without a CRAM read among them the CRAM and its
flipped copy are not written. It
prints one JSON line per turn and, last, one JSON object with each
phase's value per tree in turn order. Work files go under ``.smoke/``
of the checkout that holds this script, removed at the end.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
import zlib

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ["inflate", "parse", "rans_simd", "rans", "inflate_legacy"]
CRAM_WRITE_RECORDS = 200_000

# B2's memory traffic without its parse: per record the start, the 3
# aligned 16-byte vectors that hold most of its prefix, 12 int32 stores
GATHER_FLOOR = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void gather_floor(const uint8_t* blob, const int64_t* starts,
                             int64_t n, uint32_t* out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4* b = (const uint4*)((uintptr_t)(blob + starts[i]) & ~(uintptr_t)15);
  uint4 x = __ldg(b), y = __ldg(b + 1), z = __ldg(b + 2);
  uint32_t w[12] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w, z.x, z.y, z.z, z.w};
  for (int k = 0; k < 12; k++) out[k * n + i] = w[k];
}
extern "C" int disq_gather_floor(const void* blob, const void* starts,
                                 int64_t n, void* out, void* stream) {
  gather_floor<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)blob, (const int64_t*)starts, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}
"""


def build_floor(work: str) -> str:
    """``GATHER_FLOOR`` built with the port's nvcc flags into ``work``."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    src, lib = os.path.join(work, "floor.cu"), os.path.join(work, "libfloor.so")
    with open(src, "w") as f:
        f.write(GATHER_FLOOR)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib, src], check=True)
    return lib


def smoke_helpers():
    """This checkout's ``chip_smoke.py``, loaded by path: both trees' turns
    time with the same helpers."""
    spec = importlib.util.spec_from_file_location(
        "pairs_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profiled_ms(torch, fn, kernel: str, iters: int = 10):
    """Device time per call of the CUDA kernel whose name contains
    ``kernel``, from ``torch.profiler`` with CUDA activity: the summed
    device time of its launches over ``iters`` calls, per call (after one
    warm-up call). None when the profiler shows no device time for it;
    the names it did show are logged then. On the card's machine it has
    dropped launches of kernels that run for milliseconds, so it serves
    the short B2 here, beside ``parse_graph_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us, seen = 0.0, []
    for e in prof.events():
        t = e.device_time_total if e.device_type == DeviceType.CUDA else 0
        if t > 0:
            seen.append(e.name[:60])
            if kernel in e.name:
                us += t
    if us > 0:
        return us / iters / 1e3
    print(f"profiler: no device time for {kernel!r}; kernels seen "
          f"{sorted(set(seen))[:8]}", file=sys.stderr)
    return None


def parse_times(torch, smoke, bam: str, split_size: int, floor: str) -> dict:
    """Kernel B2 (the tree's ``parse_records``) on split 0's records:
    the split's blocks inflated with zlib into one blob on the card, the
    record starts found by walking ``block_size`` from the header's end,
    every record whose 36-byte prefix lies in the blob."""
    from disq_tpu_torch.ops import parse as B2

    with open(bam, "rb") as f:
        data = f.read()
    blocks = [b for b in smoke.walk_blocks(data) if b[0] < split_size]
    raw = b"".join(zlib.decompress(data[p + h: p + t - 8], -15)
                   for p, t, h in blocks)
    starts, p = [], len(smoke.bam_header())
    while p + 36 <= len(raw):
        starts.append(p)
        p += 4 + int.from_bytes(raw[p: p + 4], "little", signed=True)
    blob = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to("cuda")
    st = torch.tensor(starts, dtype=torch.int64, device="cuda")
    call = lambda: B2.parse_records(blob, st)  # noqa: E731
    lib = ctypes.CDLL(floor)
    lib.disq_gather_floor.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int64] + [ctypes.c_void_p] * 2
    out = torch.empty((12, len(starts)), dtype=torch.int32, device="cuda")

    def gather():
        stream = torch.cuda.current_stream().cuda_stream
        if lib.disq_gather_floor(blob.data_ptr(), st.data_ptr(), len(starts),
                                 out.data_ptr(), stream):
            raise SystemExit("gather_floor launch failed")

    return {"parse_records": len(starts),
            "parse_device_ms": profiled_ms(torch, call, "parse_kernel", 20),
            "parse_graph_ms": smoke.graph_ms(torch, call),
            "parse_wrapper_ms": smoke.cuda_ms(torch, call, 3, 20),
            "parse_floor_ms": profiled_ms(torch, gather, "gather_floor", 20)}


# the phases that read the CRAM or its flipped copy (``--phases`` without
# any of them skips writing both)
CRAM_READS = ("cram_read_s", "cram_executor4_read_s", "cram_policy_reads",
              "cram_legacy_read_s")
PHASES = ("parse", "bam_read_s", "sort_write_s", "executor4_read_s",
          "legacy_read_s", "cram_write_s") + CRAM_READS


def child(args) -> dict:
    smoke = smoke_helpers()
    sys.path.insert(0, args.tree)
    import torch

    import disq_tpu_torch as port
    from disq_tpu_torch.ops import cuda_build

    tree = os.path.realpath(args.tree)
    if not os.path.realpath(port.__file__).startswith(tree + os.sep):
        raise SystemExit(f"imported {port.__file__}, not the port of {tree}")
    torch.zeros(1, device="cuda")
    cuda_build.build(KERNELS)

    def storage():
        # a fresh storage per phase: the builders set options in place
        return port.ReadsStorage.make_default().split_size(args.split_size)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def held(ds, what, key=None):
        want = json.load(open(args.want))
        w = want[key] if key else want
        got = [ds.count(), ds.flagstat()]
        if got != [w["count"], w["flagstat"]]:
            raise SystemExit(f"{what}: count/flagstat {got} != {w}")

    if args.make_cram:
        ds = storage().read(args.bam)
        os.environ["DISQ_TPU_TORCH_CRAM_RANS_O1"] = "0"
        storage().write(ds.coordinate_sorted(), args.cram,
                        port.CraiWriteOption.ENABLE)
        return {"cram_bytes": os.path.getsize(args.cram)}
    phases = args.phases.split(",") if args.phases else PHASES
    res = {}

    def read_phase(key, path, what, make=storage, want_key=None):
        ds, res[key] = timed(lambda: make().read(path))
        held(ds, what, want_key)

    if "parse" in phases:
        res.update(parse_times(torch, smoke, args.bam, args.split_size,
                               args.floor))
    if "bam_read_s" in phases:
        read_phase("bam_read_s", args.bam, "bam read")
    if "sort_write_s" in phases:
        ds = storage().read(args.bam)
        out = os.path.join(os.path.dirname(args.bam), "sorted.bam")
        _, res["sort_write_s"] = timed(lambda: storage().write(
            ds, out, port.BaiWriteOption.ENABLE, sort=True))
        del ds
    if "executor4_read_s" in phases:
        read_phase("executor4_read_s", args.bam, "4-worker read",
                   lambda: storage().executor_workers(4))
    if "legacy_read_s" in phases:
        os.environ["DISQ_TPU_TORCH_DEVICE_INFLATE"] = "legacy"
        read_phase("legacy_read_s", args.bam, "legacy read")
        del os.environ["DISQ_TPU_TORCH_DEVICE_INFLATE"]
    if "cram_write_s" in phases:
        # the single-file CRAM write of the first CRAM_WRITE_RECORDS
        # sorted records, with its CRAI; the sort is set-up
        srt = storage().read(args.bam).coordinate_sorted()
        head = port.ReadsDataset(srt.header,
                                 srt.reads.slice(0, CRAM_WRITE_RECORDS))
        del srt
        out = os.path.join(os.path.dirname(args.bam), "head.cram")
        os.environ["DISQ_TPU_TORCH_CRAM_RANS_O1"] = "0"
        _, res["cram_write_s"] = timed(lambda: storage().write(
            head, out, port.CraiWriteOption.ENABLE))
        del os.environ["DISQ_TPU_TORCH_CRAM_RANS_O1"]
        back = storage().read(out)
        if back.count() != CRAM_WRITE_RECORDS or not np.array_equal(
                back.reads.pos, head.reads.pos):
            raise SystemExit("cram write: the re-read differs")
        del head, back
    if "cram_read_s" in phases:
        read_phase("cram_read_s", args.cram, "cram read")
    if "cram_executor4_read_s" in phases:
        read_phase("cram_executor4_read_s", args.cram, "4-worker cram read",
                   lambda: storage().executor_workers(4))
    if "cram_policy_reads" in phases:
        from disq_tpu_torch.runtime.errors import CorruptBlockError

        for policy in ("skip", "quarantine"):
            shutil.rmtree(args.flipped + ".quarantine", ignore_errors=True)
            try:
                read_phase(f"cram_{policy}_read_s", args.flipped,
                           f"cram {policy} read",
                           lambda: storage().error_policy(policy), "policy")
            except CorruptBlockError:
                res[f"cram_{policy}_read_s"] = None  # the policy is ignored
    if "cram_legacy_read_s" in phases:
        os.environ["DISQ_TPU_TORCH_DEVICE_RANS"] = "legacy"
        read_phase("cram_legacy_read_s", args.cram, "legacy cram read")
        del os.environ["DISQ_TPU_TORCH_DEVICE_RANS"]
    return res


def run_child(tree: str, args, files: dict, make_cram: bool = False) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--child", "--tree", tree,
           "--split-size", str(args.split_size), *(f"--{k}={v}" for k, v in files.items())]
    if args.phases:
        cmd.append(f"--phases={args.phases}")
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
    ap.add_argument("--phases", help="comma-separated subset of "
                    + ",".join(PHASES) + " (default: all)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--make-cram", action="store_true", help=argparse.SUPPRESS)
    for k in ("tree", "bam", "cram", "flipped", "want", "floor"):
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
                 "flipped": os.path.join(work, "sorted_flipped.cram"),
                 "want": os.path.join(work, "want.json"),
                 "floor": build_floor(work)}
        g = chip_smoke.synthesize(args.records, args.seed)
        chip_smoke.write_bam(files["bam"], g, args.records)
        want = {"count": args.records,
                "flagstat": chip_smoke.numpy_flagstat(g["flag"])}
        phases = args.phases.split(",") if args.phases else PHASES
        unknown = set(phases) - set(PHASES)
        if unknown:
            raise SystemExit(f"unknown phases {sorted(unknown)}")
        if set(phases) & set(CRAM_READS):
            make = {k: v for k, v in files.items() if k in ("bam", "cram")}
            print(json.dumps(run_child(new, args, make, make_cram=True)),
                  flush=True)
            data = open(files["cram"], "rb").read()
            offsets = chip_smoke.crai_container_offsets(
                files["cram"] + ".crai")
            fields = [chip_smoke.container_fields(data, off)
                      for off in offsets]
            *_, flipped, keep = chip_smoke.flip_cram_container(
                files["cram"], data, offsets, fields, args.split_size)
            del data
            perm = np.argsort(
                chip_smoke.coordinate_keys(g["refid"], g["pos"]),
                kind="stable")
            want["policy"] = {"count": int(keep.sum()),
                              "flagstat": chip_smoke.numpy_flagstat(
                                  g["flag"][perm][keep])}
        with open(files["want"], "w") as f:
            json.dump(want, f)
        del g
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
