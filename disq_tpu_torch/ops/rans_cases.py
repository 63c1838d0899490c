"""Order-0 rANS streams at the edges of the B3 kernel's design.

The kernel decodes a superstep's four states together, reads their
renorm bytes from one 8-byte window and stores its output in words, so
its edges are: raw sizes that end inside a superstep, a one-symbol
stream (its frequency, 4096, needs 13 bits), a table with all 256
symbols, a superstep whose four states take two renorm bytes each, and
a stream that overruns inside its last superstep. ``edge_streams``
builds them with the caller's encoder; ``superstep_renorms`` counts
each superstep's renorm bytes by a serial decode, so the callers can
check that the cases reach those edges.
"""

from __future__ import annotations

import struct
from typing import Callable, List, Tuple

import numpy as np

RANS_LOW = 1 << 23


def eight_renorm_raw(n: int = 4096) -> bytes:
    """Mostly 'A', with 64 groups of four distinct rare symbols at
    4-aligned offsets, the last group at the end: each rare symbol gets
    frequency 1, so its state takes at least one renorm byte and two
    about half the time, and some group's four states all take two in
    one superstep."""
    raw = bytearray(b"A" * n)
    pool = [b for b in range(256) if b != ord("A")]
    for g in range(64):
        at = n - 4 if g == 63 else 64 * g
        for j in range(4):
            raw[at + j] = pool[(4 * g + j) % len(pool)]
    return bytes(raw)


def edge_raws() -> List[Tuple[str, bytes]]:
    rng = np.random.default_rng(23)
    raws = [(f"raw{k}", rng.integers(60, 70, k, dtype=np.uint8).tobytes())
            for k in range(1, 8)]
    raws.append(("one_symbol", b"Q" * 1001))
    raws.append(("all_256", bytes(range(256)) * 16))
    raws.append(("eight_renorm", eight_renorm_raw()))
    return raws


def superstep_renorms(stream: bytes) -> List[int]:
    """Renorm bytes each superstep of an order-0 stream consumes, by the
    kernels' serial loop (a read past the body still counts)."""
    from disq_tpu_torch.ops.rans_simd import _parse_stream

    meta = _parse_stream(0, stream)
    if meta is None:
        return []
    raw, body, states, freqs, cum = meta
    lookup = np.repeat(np.arange(256), freqs)
    x = [int(s) for s in states]
    off, out = 0, []
    for k in range(0, raw, 4):
        start = off
        for j in range(min(4, raw - k)):
            m = x[j] & 0xFFF
            s = int(lookup[m])
            xj = (int(freqs[s]) * (x[j] >> 12) + m - int(cum[s])) & 0xFFFFFFFF
            for _ in range(2):
                if xj < RANS_LOW:
                    xj = (xj << 8) | (body[off] if off < len(body) else 0)
                    off += 1
            x[j] = xj
        out.append(off - start)
    return out


def truncated(stream: bytes, cut: int) -> bytes:
    """``stream`` with its last ``cut`` renorm bytes dropped and its
    compressed size rewritten to match."""
    enc = bytearray(stream)
    comp = struct.unpack_from("<I", enc, 1)[0]
    struct.pack_into("<I", enc, 1, comp - cut)
    return bytes(enc[: 9 + comp - cut])


def edge_streams(encode: Callable[[bytes], bytes]):
    """``(names, raws, streams, truncated streams)``: the edge raws
    encoded, and a copy of the eight-renorm stream cut by the bytes its
    last superstep reads, so that it overruns there and nowhere before."""
    names, raws = zip(*edge_raws())
    streams = [encode(r) for r in raws]
    last = streams[names.index("eight_renorm")]
    cut = truncated(last, superstep_renorms(last)[-1])
    return list(names), list(raws), streams, [cut]
