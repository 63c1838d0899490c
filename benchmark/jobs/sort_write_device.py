"""``sort_write``'s jobs with the device write: the storage deploys
``.device_deflate()``, so each shard's records are gathered on the card
(W1) and deflated there (W2). Read, sort, traffic, judgement and control
are ``sort_write``'s. A traced window also books the bytes the two
rooflines count: W1 each written record byte once plus 16 bytes of
offsets per record, W2 the deflate payload and the decoded bytes of the
written file's blocks (the benchmark's own walk of the kept file)."""

from __future__ import annotations

import numpy as np

from benchmark.jobs import common, sort_write
from benchmark.jobs.sort_write import control, release, verify  # noqa: F401


def setup(ctx):
    """``sort_write.setup`` on the device-write storage: the full-size
    read and sort, and a write of the sorted file's first records, which
    builds and runs W1 and W2."""
    st = common.storage(ctx).device_deflate()
    out, _ = sort_write._paths(ctx, "out.bam")
    ds = st.read(ctx.inputs["path"])
    ds.count()
    srt = ds.coordinate_sorted()
    head = type(ds)(header=srt.header,
                    reads=srt.reads.take(np.arange(min(
                        sort_write.WARM_RECORDS, srt.count()))),
                    device=ds.device)
    st.write(head, out, ctx.port.BaiWriteOption.ENABLE, sort=True)
    ctx.sync()
    del ds, srt, head
    return {"storage": st, "out": out,
            "bytes": common.block_bytes(ctx.inputs["path"]) if ctx.trace
            else {}}


def window(ctx, state, seconds):
    win = sort_write.window(ctx, state, seconds)
    if ctx.trace:
        kept = state["judged"][0]
        written = common.block_bytes(kept)
        win["facts"].update(
            gather_bytes=ctx.inputs["record_bytes"] + 16 * ctx.inputs[
                "records"],
            deflate_bytes=written["payload_bytes"] + written["decoded_bytes"])
    return win
