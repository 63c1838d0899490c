"""rANS-4x8 order-0 decode of many CRAM streams in one launch (kernel B3).

The function of the reference's ``_rans0_simd_kernel``: each stream has
4 interleaved states (state ``i & 3`` decodes output byte ``i``), a
12-bit frequency table (sum 4096) and byte-wise renormalization from
below 2^23, at most 2 renorm bytes per symbol. The symbol of slot
``m = x & 0xFFF`` is ``min(255, |{r in 1..256 : cum[r] <= m}|)``. A
renorm read past the stream's ``clen`` renorm bytes yields 0 and still
counts as consumed, so an overrun shows as ``used > clen``: status 6.

Layout: every stream's renorm bytes lie in one blob at int64 offsets
``ren_off``; its output goes to one blob at its raw-size prefix-sum
offset ``out_off``; its 4 initial states and 256 frequencies are one
row of ``states`` and ``freq``. There is no size cap: any stream goes
to the kernel.

On a CUDA tensor ``rans0_decode`` launches ``csrc/rans_simd.cu`` (one
warp per stream, all streams of a call in one launch: a packed
4096-slot table and a renorm-byte ring in shared memory, the four
states of a superstep decoded together); on a CPU
tensor it runs ``rans0_decode_plain``, the same function in torch ops,
vectorised across streams with one loop turn per superstep (slow on
megabyte streams: it is a check, not a route). ``rans0_decode_simd`` is
the host side: header and table parse (``_parse_stream``), staging, one
launch, and the status check. ``launch_streams`` / ``fetch_streams`` are
the device service's split of it: parsed streams staged into a pinned
arena, copied and decoded on the current stream without a wait, and
fetched once the launch's event has completed.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from disq_tpu_torch.runtime import counters
from disq_tpu_torch.runtime.tracing import device_span

RANS_LOW = 1 << 23
TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT
STATUS_OVERRUN = 6

# cumulative dispatch diagnostics, as ops/inflate_simd.last_stats: streams
# the kernel decoded, streams sent to the host for size (none: no cap),
# flagged streams decoded on the host (none: a flagged stream raises)
last_stats = {"device_lanes": 0, "host_big": 0, "host_fallback": 0}


def _parse_stream(k: int, s: bytes):
    """Host-side header/table parse (O(alphabet) per stream — the
    per-byte loop is the kernel's): ``None`` for an empty stream, else
    ``(raw_size, renorm bytes, states, freqs, cum)``."""
    from disq_tpu_torch.cram.rans import _read_freq_table0

    order, comp_size, raw_size = struct.unpack_from("<BII", s, 0)
    if order != 0:
        raise ValueError(f"stream {k}: kernel handles order-0 only")
    if raw_size == 0:
        return None
    body = bytes(s[9: 9 + comp_size])
    freqs, off = _read_freq_table0(body, 0)
    if int(freqs.sum()) != TOTFREQ:
        raise ValueError(f"stream {k}: frequency table sum != 4096")
    states = np.frombuffer(body, dtype="<u4", count=4, offset=off)
    if int(states.max(initial=0)) >= 1 << 31:
        raise ValueError(f"stream {k}: corrupt rANS state word >= 2^31")
    # a valid encoder leaves every final state in [RANS_LOW, RANS_LOW<<8)
    # (unused states of a short stream stay exactly RANS_LOW); below the
    # bound the host renorm loop takes >2 bytes/symbol and the kernels'
    # 2-step unroll would silently diverge from it
    if int(states.min(initial=RANS_LOW)) < RANS_LOW:
        raise ValueError(f"stream {k}: corrupt rANS state word < 2^23")
    cum = np.zeros(257, dtype=np.int64)
    np.cumsum(freqs, out=cum[1:])
    return raw_size, body[off + 16:], states, freqs, cum


@torch.inference_mode()
def decode_supersteps(ren: torch.Tensor, ren_off: torch.Tensor,
                      out_off: torch.Tensor, states: torch.Tensor,
                      freq: torch.Tensor, symbol_of: Callable):
    """The plain decode shared by B3's and B5's plain versions, in torch
    ops on the inputs' device: vectorised across streams and over the 4
    states, one loop turn per superstep (output bytes 4k..4k+3 of every
    stream). ``symbol_of(m)`` maps the (n, 4) slots ``x & 0xFFF`` to
    symbols; each module passes its kernel's way of doing it.

    The states decode in order 0..3 as in the kernels: state j's renorm
    bytes follow those of states < j. How many a state takes depends on
    its new value alone (one below 2^23, two below 2^15, since
    ``(x << 8) | b < 2^23`` exactly when ``x < 2^15``), so a state's
    first renorm byte is an exclusive prefix sum over the superstep, and
    one read of the 16-bit word there serves both steps. A read past
    ``clen`` yields 0 and still counts in ``used``."""
    dev = ren.device
    n = states.shape[0]
    raw = out_off[1:] - out_off[:-1]
    clen = (ren_off[1:] - ren_off[:-1])[:, None]
    # every stream's bytes followed by one 0 (the slot a read at or past
    # clen lands on); word[q] = body[q] << 8 | body[q + 1], 0 at the 0s
    base = (ren_off[:-1] + torch.arange(n, device=dev))[:, None]
    body = torch.zeros(ren.numel() + n + 1, dtype=torch.int64, device=dev)
    body[torch.arange(ren.numel(), device=dev)
         + torch.repeat_interleave(torch.arange(n, device=dev),
                                   clen[:, 0], output_size=ren.numel())] = \
        ren.long()
    word = (body[:-1] << 8) | body[1:]
    word[(base + clen)[:, 0]] = 0
    f = freq.long()
    cum = torch.cumsum(f, 1) - f
    x = states.long() & 0xFFFFFFFF
    used = torch.zeros(n, 1, dtype=torch.int64, device=dev)
    steps = (int(raw.max()) + 3) // 4 if n else 0
    out = torch.zeros(n, steps * 4, dtype=torch.uint8, device=dev)
    lane = torch.arange(4, device=dev)
    full = int(raw.min()) // 4 if n else 0   # supersteps no stream ends in
    for k in range(steps):
        m = x & (TOTFREQ - 1)
        s = symbol_of(m)
        xn = (f.gather(1, s) * (x >> TF_SHIFT) + m - cum.gather(1, s)) \
            & 0xFFFFFFFF
        one = xn < RANS_LOW
        two = xn < RANS_LOW >> 8
        if k >= full:
            active = (4 * k + lane) < raw[:, None]
            one &= active
            two &= active
        cnt = one.long() + two
        ends = torch.cumsum(cnt, 1)
        w = word[torch.minimum(ends - cnt + used, clen) + base]
        xn = torch.where(two, (xn << 16) | w,
                         torch.where(one, (xn << 8) | (w >> 8), xn))
        x = torch.where(active, xn, x) if k >= full else xn
        used = used + ends[:, 3:]
        out[:, 4 * k: 4 * k + 4] = s
    keep = torch.arange(steps * 4, device=dev)[None, :] < raw[:, None]
    used = used[:, 0]
    status = (used > clen[:, 0]).int() * STATUS_OVERRUN
    return out[keep], used, status


def rans0_decode_plain(ren: torch.Tensor, ren_off: torch.Tensor,
                       out_off: torch.Tensor, states: torch.Tensor,
                       freq: torch.Tensor):
    """B3's plain version: the kernel's inputs and outputs, the symbol
    of slot ``m`` taken as ``_rans0_simd_kernel`` takes it, by a masked
    compare-and-sum over the cumulative frequencies:
    ``min(255, |{r in 1..256 : cum[r] <= m}|)``."""
    ends = torch.cumsum(freq.long(), 1)[:, None, :]   # cum[1..256]

    def symbol_of(m):
        return (ends <= m[..., None]).sum(-1).clamp_(max=255)

    return decode_supersteps(ren, ren_off, out_off, states, freq, symbol_of)


# -- the kernel wrapper -----------------------------------------------------


def check_inputs(ren, ren_off, out_off, states, freq) -> int:
    """Validate the kernel inputs (shared with ``ops/rans.py``); returns
    the stream count."""
    dev = ren.device
    want = (("ren", ren, torch.uint8, 1), ("ren_off", ren_off, torch.int64, 1),
            ("out_off", out_off, torch.int64, 1),
            ("states", states, torch.int32, 2), ("freq", freq, torch.int32, 2))
    for name, t, dtype, dim in want:
        if t.dtype != dtype or t.device != dev or t.dim() != dim \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: want a contiguous {dim}-D {dtype} tensor on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    n = states.shape[0]
    if states.shape != (n, 4) or freq.shape != (n, 256) \
            or ren_off.numel() != n + 1 or out_off.numel() != n + 1:
        raise ValueError(
            "want states (n, 4), freq (n, 256), ren_off and out_off (n+1,); "
            f"got {tuple(states.shape)}, {tuple(freq.shape)}, "
            f"{ren_off.numel()}, {out_off.numel()}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"rANS decode runs on cuda or cpu, not {dev}")
    return n


def launch(kernel: str, entry: str, ren, ren_off, out_off, states, freq,
           total: int):
    """Allocate the outputs and launch the C entry ``entry`` of
    ``csrc/<kernel>.cu``; books one launch."""
    from disq_tpu_torch.ops import cuda_build

    dev = ren.device
    n = states.shape[0]
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    used = torch.empty(n, dtype=torch.int64, device=dev)
    status = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        lib = cuda_build.load(kernel)
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] + \
                [ctypes.c_void_p] * 4
        with torch.cuda.device(dev):
            rc = fn(ren.data_ptr(), ren_off.data_ptr(), out_off.data_ptr(),
                    states.data_ptr(), freq.data_ptr(), n, out.data_ptr(),
                    used.data_ptr(), status.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check_launch(kernel, rc)
        counters.book_launch(kernel)
    return out, used, status


def rans0_decode(ren: torch.Tensor, ren_off: torch.Tensor,
                 out_off: torch.Tensor, states: torch.Tensor,
                 freq: torch.Tensor, total: int):
    """Decode n order-0 streams: returns ``(out uint8[total], used
    int64[n], status int32[n])``, where ``total == out_off[-1]``. Stream i's renorm bytes are
    ``ren[ren_off[i]:ren_off[i+1]]``, its output ``out[out_off[i]:
    out_off[i+1]]``; ``states`` (n, 4) int32 holds its initial states
    (each in [2^23, 2^31)) and ``freq`` (n, 256) int32 its frequencies
    (each row sums to 4096) — ``_parse_stream`` checks both."""
    check_inputs(ren, ren_off, out_off, states, freq)
    if ren.device.type == "cpu":
        return rans0_decode_plain(ren, ren_off, out_off, states, freq)
    return launch("rans_simd", "disq_rans_simd_launch", ren, ren_off,
                  out_off, states, freq, total)


# -- host side of the device route ------------------------------------------


def stream_error(error: BaseException, k: int) -> BaseException:
    """``error`` marked with the index of the stream it concerns, so a
    caller that batched many containers' streams can name the container
    (the exception's type and message stay as raised)."""
    error.stream = k
    return error


def stage_streams(streams: Sequence[bytes], device,
                  bad: Optional[Dict[int, BaseException]] = None):
    """Parse every stream and upload the kernel inputs: returns ``(live
    indices, (ren, ren_off, out_off, states, freq), (host ren_off, host
    out_off))``, the live streams being those with bytes to decode. A
    stream that does not parse raises its parse error, marked by
    ``stream_error``; given a dict ``bad``, its error is recorded there
    under its index instead and the stream stays out of the launch."""
    from disq_tpu_torch.runtime.device_pipeline import upload

    device = torch.device(device)
    metas = []
    for k, s in enumerate(streams):
        try:
            metas.append(_parse_stream(k, s))
        except Exception as e:  # noqa: BLE001 — re-raised as it is, marked
            if bad is None:
                raise stream_error(e, k)
            bad[k] = stream_error(e, k)
            metas.append(None)
    live = [k for k, m in enumerate(metas) if m is not None]
    pieces, ren_off, out_off, states, freq = pack_streams(
        [metas[k] for k in live])
    ren = np.frombuffer(b"".join(pieces), dtype=np.uint8)
    args = tuple(upload(a, device) for a in (ren, ren_off, out_off, states,
                                             freq))
    return live, args, (ren_off, out_off)


def pack_streams(metas: Sequence):
    """The kernel inputs of parsed streams (``_parse_stream`` results):
    ``(renorm byte pieces, ren_off, out_off, states, freq)``."""
    n = len(metas)
    ren_off = np.zeros(n + 1, dtype=np.int64)
    out_off = np.zeros(n + 1, dtype=np.int64)
    states = np.zeros((n, 4), dtype=np.int32)
    freq = np.zeros((n, 256), dtype=np.int32)
    for i, (raw_size, renorm, st, fr, _cum) in enumerate(metas):
        ren_off[i + 1] = ren_off[i] + len(renorm)
        out_off[i + 1] = out_off[i] + raw_size
        states[i] = st.astype(np.int64)
        freq[i] = fr
    return [m[1] for m in metas], ren_off, out_off, states, freq


class StreamLaunch:
    """One ``launch_streams`` in flight."""

    __slots__ = ("staged", "outputs", "event", "ren_off", "out_off")

    def __init__(self, staged, outputs, event, ren_off, out_off) -> None:
        self.staged, self.outputs, self.event = staged, outputs, event
        self.ren_off, self.out_off = ren_off, out_off


def launch_streams(metas: Sequence, device) -> StreamLaunch:
    """Stage parsed order-0 streams in a pinned arena and enqueue the
    copy and B3 on the current stream without waiting."""
    from disq_tpu_torch.ops.inflate_simd import Staged, record_event

    pieces, ren_off, out_off, states, freq = pack_streams(metas)
    staged = Staged("rans", [pieces, ren_off, out_off, states, freq], device)
    try:
        outputs = rans0_decode(*staged.tensors, int(out_off[-1]))
        event = record_event(device)
    except BaseException:
        staged.release()
        raise
    return StreamLaunch(staged, outputs, event, ren_off, out_off)


def fetch_streams(handle: StreamLaunch):
    """Wait for a ``launch_streams`` and bring its outputs back:
    ``(blob, used, status, ren_off, out_off)`` on the host."""
    with device_span("device.kernel", kernel="rans_simd",
                     lanes=len(handle.out_off) - 1):
        if handle.event is not None:
            handle.event.synchronize()
    handle.staged.release()
    host = fetch(*handle.outputs)
    handle.outputs = None
    return (*host, handle.ren_off, handle.out_off)


def fetch(out: torch.Tensor, used: torch.Tensor, status: torch.Tensor):
    """The kernel's outputs on the host (books d2h bytes for a card)."""
    host = [t.cpu().numpy() for t in (out, used, status)]
    if out.is_cuda:
        counters.book_transfer("d2h", sum(a.nbytes for a in host))
    return host


def decode_streams(streams: Sequence[bytes], device, decode: Callable,
                   stats: dict,
                   bad: Optional[Dict[int, BaseException]] = None,
                   span_labels: Optional[dict] = None
                   ) -> List[Optional[bytes]]:
    """The host side shared by B3 and B5: stage ``streams``, decode them
    in one call of ``decode`` (``rans0_decode`` or ``rans.
    rans0_decode_legacy``), check the statuses and slice the output;
    ``stats["device_lanes"]`` counts the streams decoded. A stream that
    does not parse raises its parse error, and one the kernel flags a
    ``ValueError`` with the reference B5's message, each marked by
    ``stream_error``. Given a dict
    ``bad``, every such stream's error is recorded there under its index
    instead, its output is None, and the other streams keep theirs (one
    launch all the same; nothing is decoded again). The launch and its
    fetch run under a ``device.kernel`` span labeled ``span_labels``."""
    if not streams:
        return []
    live, args, (ren_off, out_off) = stage_streams(streams, device, bad)
    out: List[Optional[bytes]] = [b""] * len(streams)
    for k in bad or ():
        out[k] = None
    if not live:
        return out
    with device_span("device.kernel", **(span_labels or {})):
        blob, used, status = fetch(*decode(*args, int(out_off[-1])))
    clen = np.diff(ren_off)
    flagged = set()
    for i in np.nonzero(status)[0].tolist():
        e = stream_error(ValueError(
            f"device rANS decode overran stream {live[i]} "
            f"(consumed {int(used[i])} of {int(clen[i])})"), live[i])
        if bad is None:
            raise e
        bad[live[i]] = e
        out[live[i]] = None
        flagged.add(i)
    counters.add_stats(stats, device_lanes=len(live) - len(flagged))
    for i, k in enumerate(live):
        if i not in flagged:
            out[k] = blob[out_off[i]: out_off[i + 1]].tobytes()
    return out


def rans0_decode_simd(streams: Sequence[bytes], device,
                      bad: Optional[Dict[int, BaseException]] = None
                      ) -> List[Optional[bytes]]:
    """Decode order-0 rANS 4x8 streams (full streams incl. the 9-byte
    header) on ``device``, all of them in one launch of B3. A stream the
    kernel flags (renorm consumed past its compressed length) is corrupt
    input and raises ``ValueError`` naming it, or with ``bad`` is
    recorded there (``decode_streams``); there is no host re-decode and
    no size cap."""
    return decode_streams(streams, device, rans0_decode, last_stats, bad,
                          {"kernel": "rans_simd", "lanes": len(streams)})
