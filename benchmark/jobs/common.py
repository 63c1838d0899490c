"""What the traffic kinds share: the storage a configuration describes,
the benchmark's own byte count of a BGZF file, a seed-drawn sample of
passes and the timed loop of whole passes."""

from __future__ import annotations

import random
import struct
import time
from typing import Any, Dict, Optional

import numpy as np

from benchmark.harness.core import log
from benchmark.reference.bam import walk_blocks


def storage(ctx):
    """The program's reads storage as the configuration deploys it."""
    c = ctx.config
    st = ctx.port.ReadsStorage.make_default(device=ctx.device) \
        .split_size(int(c["split_size"])) \
        .executor_workers(int(c["executor_workers"]))
    if "write_shards" in c:
        st = st.num_shards(int(c["write_shards"])) \
            .writer_workers(int(c["writer_workers"]))
    return st


def block_bytes(path: str) -> Dict[str, int]:
    """The benchmark's own walk of a BGZF file: deflate payload bytes
    and decoded bytes of its blocks (ISIZE)."""
    with open(path, "rb") as f:
        data = f.read()
    payload = decoded = 0
    for p, total, hdr in walk_blocks(data):
        payload += total - hdr - 8
        decoded += struct.unpack_from("<I", data, p + total - 4)[0]
    return {"payload_bytes": payload, "decoded_bytes": decoded}


class Sample:
    """One item drawn uniformly from the seed among all offered
    (reservoir sampling): ``drawn`` is ``(index, item)``."""

    def __init__(self, seed: int) -> None:
        self._rng = random.Random(seed)
        self.seen = 0
        self.drawn: Optional[tuple] = None

    def offer(self, index: int, item: Any) -> bool:
        """Offer ``item``; True when it replaced the drawn one."""
        self.seen += 1
        if self._rng.randrange(self.seen) == 0:
            self.drawn = (index, item)
            return True
        return False


def timed_loop(ctx, seconds: float, one_pass) -> Dict[str, Any]:
    """Whole passes back to back: a pass that starts before ``seconds``
    have passed runs to its end, and each ends in a device synchronize.
    ``one_pass(i)`` returns the records it handled."""
    t_first = time.perf_counter()
    records, ends = [], []
    while True:
        if ends and time.perf_counter() - t_first >= seconds:
            break
        records.append(one_pass(len(ends)))
        ctx.sync()
        ends.append(time.perf_counter())
    pass_s = np.diff([t_first] + ends)
    log(f"passes: {len(ends)}, seconds each: first {pass_s[0]:.3f}, min "
        f"{pass_s.min():.3f}, median {np.median(pass_s):.3f}, max "
        f"{pass_s.max():.3f}")
    return {"records": records, "t_first": t_first, "t_last": ends[-1],
            "elapsed": ends[-1] - t_first, "passes": len(ends)}
