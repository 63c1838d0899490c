#!/usr/bin/env python
"""torch_serve — run the port's multi-tenant interval-query daemon, or
its fleet router, from the shell.

Registers the given datasets and serves region queries over HTTP until
SIGTERM or Ctrl-C (``disq_tpu_torch/runtime/serve.py``; the README's
"Serving and fleet" section lists the endpoints). Every cache-missing
block of a query is inflated on ``--device`` (``cuda`` by default)::

    python scripts/torch_serve.py --port 8765 \\
        --dataset wgs=/data/sample.bam \\
        --dataset calls=/data/sample.vcf.bgz

    curl -s -XPOST localhost:8765/query/reads -d '{
        "dataset": "wgs", "tenant": "alice",
        "intervals": [{"contig": "chr1", "start": 1, "end": 100000}]}'

With ``--fleet`` the process runs the routing tier instead of a replica
(``runtime/fleet.py``): queries POSTed to ``/fleet/query/*`` go to the
replica whose hot-block cache already holds their blocks, hedged to the
runner-up on tail latency::

    python scripts/torch_serve.py --port 8800 \\
        --fleet 127.0.0.1:8765,127.0.0.1:8766 \\
        --dataset wgs=/data/sample.bam

The first line of standard output names the address.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serve interval queries over registered datasets")
    ap.add_argument("--port", type=int, default=0,
                    help="HTTP port (default: ephemeral, printed)")
    ap.add_argument("--dataset", action="append", default=[],
                    metavar="NAME=PATH",
                    help="register a dataset (repeatable); its kind is "
                         "taken from the extension")
    ap.add_argument("--device", default="cuda",
                    help="the daemon's device (default cuda; 'cpu' takes "
                         "host zlib)")
    ap.add_argument("--tenant-slots", type=int, default=None,
                    help="concurrent requests per tenant")
    ap.add_argument("--tenant-queue", type=int, default=None,
                    help="queued requests per tenant before 429")
    ap.add_argument("--compressed-cache-mb", type=int, default=None,
                    help="compressed hot-block tier budget")
    ap.add_argument("--decoded-cache-mb", type=int, default=None,
                    help="decoded hot-block tier budget")
    ap.add_argument("--parsed-cache-mb", type=int, default=None,
                    help="parsed chunk-batch tier budget")
    ap.add_argument("--fleet", default=None, metavar="HOST:PORT,...",
                    help="run the fleet routing tier over these replica "
                         "endpoints instead of a replica")
    ap.add_argument("--fleet-policy", default="locality",
                    choices=("locality", "random", "roundrobin"),
                    help="replica selection policy (fleet mode)")
    ap.add_argument("--fleet-hedge-quantile", type=float, default=None,
                    help="hedge past this rolling latency quantile "
                         "(fleet mode; default 0.95, 0 turns it off)")
    args = ap.parse_args(argv)

    datasets = {}
    for spec in args.dataset:
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            ap.error(f"--dataset wants NAME=PATH, got {spec!r}")
        datasets[name] = path

    if args.fleet:
        from disq_tpu_torch.api import serve_fleet

        replicas = [e.strip() for e in args.fleet.split(",") if e.strip()]
        kwargs = {}
        if args.fleet_hedge_quantile is not None:
            q = args.fleet_hedge_quantile
            kwargs["hedge_quantile"] = q if q > 0 else None
        handle = serve_fleet(
            replicas, port=args.port, datasets=datasets,
            policy=args.fleet_policy, tenant_slots=args.tenant_slots,
            tenant_queue=args.tenant_queue, **kwargs)
        names = ", ".join(datasets) or "none (POST /fleet/register)"
        print(f"fleet router on http://{handle.address} -> "
              f"{len(replicas)} replicas  (datasets: {names})", flush=True)
    else:
        from disq_tpu_torch.api import serve

        handle = serve(
            datasets, port=args.port, device=args.device,
            tenant_slots=args.tenant_slots,
            tenant_queue=args.tenant_queue,
            compressed_cache_mb=args.compressed_cache_mb,
            decoded_cache_mb=args.decoded_cache_mb,
            parsed_cache_mb=args.parsed_cache_mb)
        names = ", ".join(datasets) or "none (POST /serve/register)"
        print(f"serving on http://{handle.address}  (device "
              f"{handle.daemon.device}; datasets: {names})", flush=True)

    stop = []
    signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
    try:
        while not stop:
            signal.pause()
    except KeyboardInterrupt:
        pass
    finally:
        handle.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
