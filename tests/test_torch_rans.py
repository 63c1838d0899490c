"""The port's order-0 rANS kernels (B3, B5) on the CPU against the JAX package.

The same numpy-seeded streams go through the reference's kernels (Pallas,
interpret mode, at most 8 streams of at most 4 KB) and through the port's
kernel wrappers on CPU tensors, which take the kernels' plain versions.
Decoded bytes must be identical (tolerance 0). At larger sizes the plain
version is held against the native host decoder, and the port's encoders
against the reference's, byte for byte. The error cases raise the
reference's exception types and messages.
"""

import struct

import numpy as np
import pytest
import torch

from disq_tpu.cram import rans as ref_rans
from disq_tpu.ops.rans import rans0_decode_device as ref_b5
from disq_tpu.ops.rans_simd import rans0_decode_simd as ref_b3
from disq_tpu_torch.cram import rans as port_rans
from disq_tpu_torch.native import rans_decode_native
from disq_tpu_torch.ops import rans as B5
from disq_tpu_torch.ops import rans_cases
from disq_tpu_torch.ops import rans_simd as B3
from disq_tpu_torch.runtime import counters

CPU = torch.device("cpu")


def _markov(n, seed, alpha=29):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.integers(0, 5, n)) % alpha).astype(np.uint8).tobytes()


def _quals(n, seed):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(34, 6, n), 2, 41).astype(np.uint8).tobytes()


def _cases():
    rng = np.random.default_rng(11)
    return {
        "tiny": [b"\x00", b"ab", b"zzzz", bytes(range(5))],
        "empty": [b"", b"q", b""],
        "single_symbol": [b"\x41" * 4000, b"\x00" * 7],
        "markov": [_markov(4000, 1), _markov(999, 2, alpha=200)],
        "mixed": [b"x", _markov(3001, 3), b"", _quals(4000, 4),
                  rng.integers(0, 256, 2500, dtype=np.uint8).tobytes(),
                  b"\x00\x01" * 7, rng.integers(0, 3, 17, dtype=np.uint8).tobytes(),
                  _quals(1234, 5)],
    }


CASES = _cases()
EMPTY = struct.pack("<BII", 0, 0, 0)   # an order-0 stream of no bytes


def _encode(raws):
    return [ref_rans.rans_encode_order0(r) for r in raws]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_b3_equals_jax_kernel(case):
    raws = CASES[case]
    streams = _encode(raws)
    want = ref_b3(streams, interpret=True)
    assert want == raws
    assert B3.rans0_decode_simd(streams, CPU) == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_b5_equals_jax_kernel(case):
    raws = CASES[case]
    streams = _encode(raws)
    want = ref_b5(streams, interpret=True)
    assert want == raws
    assert B5.rans0_decode_device(streams, CPU) == want


def _staged(streams):
    _live, args, (ren_off, out_off) = B3.stage_streams(streams, CPU)
    return args, ren_off, out_off


def test_plain_b3_equals_native_past_the_reference_caps():
    # one container's QS stream at full width: 10,000 reads of 150 bp
    raw = _quals(1_500_000, 6)
    stream = port_rans.rans_encode_order0(raw)
    args, ren_off, out_off = _staged([stream])
    assert ren_off[-1] > 32_752 and out_off[-1] > 65_536
    out, used, status = B3.rans0_decode(*args, int(out_off[-1]))
    assert out.numpy().tobytes() == rans_decode_native(stream) == raw
    assert used.tolist() == [ren_off[-1]] and status.tolist() == [0]


def _serial_decode(body, raw, states, freq):
    """The kernels' loop for one stream, one symbol at a time: the slot
    table clamps to 255 past the row's total; a renorm read past the
    body yields 0 and still counts. Returns (bytes, used, status)."""
    lookup = [255] * 4096
    cum, c = [], 0
    for s, f in enumerate(freq):
        cum.append(c)
        for k in range(min(c, 4096), min(c + f, 4096)):
            lookup[k] = s
        c += f
    x, out, off = list(states), bytearray(), 0
    for i in range(raw):
        j, m = i & 3, x[i & 3] & 0xFFF
        s = lookup[m]
        out.append(s)
        xj = (freq[s] * (x[j] >> 12) + m - cum[s]) & 0xFFFFFFFF
        for _ in range(2):
            if xj < 1 << 23:
                xj = (xj << 8) | (body[off] if off < len(body) else 0)
                off += 1
        x[j] = xj
    return bytes(out), off, 6 if off > len(body) else 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_versions_equal_a_serial_loop_on_raw_tables(seed):
    # tables and states straight into the wrappers, past _parse_stream's
    # checks: rows summing to less than 4096 (slots read as 255), random
    # states and bodies, so streams overrun at random points
    rng = np.random.default_rng(seed)
    n = 6
    raws = rng.integers(0, 300, n)
    bodies = [rng.integers(0, 256, int(rng.integers(0, 200)),
                           dtype=np.uint8).tobytes() for _ in range(n)]
    freq = np.zeros((n, 256), np.int32)
    for i in range(n):
        alive = rng.choice(256, int(rng.integers(1, 40)), replace=False)
        freq[i, alive] = rng.integers(1, 4096 // len(alive) + 1, len(alive))
    states = rng.integers(1 << 23, 1 << 31, (n, 4)).astype(np.int32)
    ren_off = np.concatenate([[0], np.cumsum([len(b) for b in bodies])])
    out_off = np.concatenate([[0], np.cumsum(raws)])
    args = (torch.from_numpy(np.frombuffer(b"".join(bodies), np.uint8).copy()),
            torch.from_numpy(ren_off), torch.from_numpy(out_off),
            torch.from_numpy(states), torch.from_numpy(freq))
    want = [_serial_decode(bodies[i], int(raws[i]), states[i].tolist(),
                           freq[i].tolist()) for i in range(n)]
    for plain in (B3.rans0_decode_plain, B5.rans0_decode_plain):
        out, used, status = plain(*args)
        assert out.numpy().tobytes() == b"".join(w[0] for w in want)
        assert used.tolist() == [w[1] for w in want]
        assert status.tolist() == [w[2] for w in want]


def test_wrapper_outputs_on_mixed_batch():
    raws = CASES["mixed"]
    args, ren_off, out_off = _staged(_encode(raws))
    for fn in (B3.rans0_decode, B5.rans0_decode_legacy):
        out, used, status = fn(*args, int(out_off[-1]))
        assert out.dtype == torch.uint8 and used.dtype == torch.int64
        assert status.dtype == torch.int32
        assert out.numpy().tobytes() == b"".join(r for r in raws if r)
        # a valid stream consumes exactly its renorm bytes
        np.testing.assert_array_equal(used.numpy(), np.diff(ren_off))
        assert not status.any()


def _truncated(raw=None, cut=60):
    """Renorm bytes chopped, comp_size rewritten to match: the decoder
    runs out of renorm bytes."""
    enc = bytearray(ref_rans.rans_encode_order0(raw or _markov(4000, 6)))
    comp_size = struct.unpack_from("<I", enc, 1)[0]
    struct.pack_into("<I", enc, 1, comp_size - cut)
    return bytes(enc[: 9 + comp_size - cut])


def _with_state(word):
    enc = bytearray(ref_rans.rans_encode_order0(b"abcd" * 50))
    _, off = ref_rans._read_freq_table0(memoryview(enc)[9:], 0)
    struct.pack_into("<I", enc, 9 + off, word)
    return bytes(enc)


def _order1():
    enc = bytearray(ref_rans.rans_encode_order0(b"abcabc"))
    enc[0] = 1
    return bytes(enc)


def _bad_freq_sum():
    enc = bytearray(ref_rans.rans_encode_order0(b"abcabcabcd"))
    # the first symbol's frequency byte (after its symbol byte)
    enc[9 + 1] += 1
    return bytes(enc)


ERRORS = {
    "order1": (_order1, "order-0 only"),
    "state_high": (lambda: _with_state(0xFFFFFFFF), "state word >= 2"),
    "state_low": (lambda: _with_state(100), "state word < 2"),
    "freq_sum": (_bad_freq_sum, "frequency table sum != 4096"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
@pytest.mark.parametrize("kernel", ["b3", "b5"])
def test_parse_errors_match_reference(kernel, case):
    make, msg = ERRORS[case]
    stream = make()
    ref, port = (ref_b3, B3.rans0_decode_simd) if kernel == "b3" else \
        (ref_b5, B5.rans0_decode_device)
    with pytest.raises(ValueError, match=msg) as want:
        ref([EMPTY, stream], interpret=True)
    with pytest.raises(ValueError, match=msg) as got:
        port([EMPTY, stream], CPU)
    assert str(got.value) == str(want.value)
    assert got.value.stream == 1


EDGE_NAMES, EDGE_RAWS, EDGE_STREAMS, EDGE_CUT = rans_cases.edge_streams(
    ref_rans.rans_encode_order0)


def test_edge_streams_reach_their_edges():
    renorms = {n: rans_cases.superstep_renorms(s)
               for n, s in zip(EDGE_NAMES, EDGE_STREAMS)}
    assert max(renorms["eight_renorm"]) == 8
    assert [len(r) for r in EDGE_RAWS[:7]] == list(range(1, 8))
    tables = {n: B3._parse_stream(0, s)[3]
              for n, s in zip(EDGE_NAMES, EDGE_STREAMS)}
    assert tables["one_symbol"].max() == 4096
    assert (tables["all_256"] > 0).all()
    # the cut stream overruns in its last superstep and nowhere before
    _args, ren_off, _out_off = _staged(EDGE_CUT)
    before_last = sum(renorms["eight_renorm"][:-1])
    assert before_last <= ren_off[-1] < sum(renorms["eight_renorm"])


@pytest.mark.parametrize("part", [slice(0, 8), slice(8, None)])
def test_plain_b3_equals_jax_kernel_on_edge_streams(part):
    raws, streams = EDGE_RAWS[part], EDGE_STREAMS[part]
    want = ref_b3(streams, interpret=True)
    assert want == raws
    assert B3.rans0_decode_simd(streams, CPU) == want
    assert B5.rans0_decode_device(streams, CPU) == want


@pytest.mark.parametrize("part", [slice(0, 8), slice(8, None)])
def test_plain_b5_equals_its_jax_kernel_on_edge_streams(part):
    """B5's plain version against B5's own JAX kernel (``_rans0_kernel``,
    through its wrapper's slot lookup), not B3's."""
    raws, streams = EDGE_RAWS[part], EDGE_STREAMS[part]
    want = ref_b5(streams, interpret=True)
    assert want == raws
    assert B5.rans0_decode_device(streams, CPU) == want


def test_plain_b5_overruns_like_its_jax_kernel_on_the_cut_edge_stream():
    with pytest.raises(ValueError, match="overran stream 0") as want:
        ref_b5(EDGE_CUT, interpret=True)
    with pytest.raises(ValueError, match="overran stream 0") as got:
        B5.rans0_decode_device(EDGE_CUT, CPU)
    assert str(got.value) == str(want.value)


def test_plain_versions_equal_native_on_edge_streams():
    assert [rans_decode_native(s) for s in EDGE_STREAMS] == EDGE_RAWS
    args, ren_off, out_off = _staged(EDGE_STREAMS + EDGE_CUT)
    for plain in (B3.rans0_decode_plain, B5.rans0_decode_plain):
        out, used, status = plain(*args)
        assert out.numpy().tobytes()[: out_off[-2]] == b"".join(EDGE_RAWS)
        np.testing.assert_array_equal(used.numpy()[:-1], np.diff(ren_off)[:-1])
        assert status.tolist() == [0] * len(EDGE_STREAMS) + [6]


def test_overrun_in_the_last_superstep_raises_like_reference():
    with pytest.raises(ValueError, match=r"code -8"):
        ref_b3(EDGE_CUT, interpret=True)
    with pytest.raises(ValueError, match="overran stream 0") as want:
        ref_b5(EDGE_CUT, interpret=True)
    with pytest.raises(ValueError, match="overran stream 0") as got:
        B3.rans0_decode_simd(EDGE_CUT, CPU)
    assert str(got.value) == str(want.value)


def test_truncated_renorm_flags_status_6_and_raises():
    cut = _truncated()
    # the reference: B3 hands the flagged lane to the host decoder, which
    # raises; B5 raises with its consumed count
    with pytest.raises(ValueError, match=r"code -8"):
        ref_b3([cut], interpret=True)
    with pytest.raises(ValueError, match="overran stream 0") as want:
        ref_b5([cut], interpret=True)
    with pytest.raises(ValueError, match="overran stream 0"):
        B3.rans0_decode_simd([cut], CPU)
    with pytest.raises(ValueError, match="overran stream 1") as got:
        B5.rans0_decode_device([EMPTY, cut], CPU)
    assert got.value.stream == 1
    # the same consumed count as the reference's B5 (it names stream 0)
    assert str(got.value).split("(")[1] == str(want.value).split("(")[1]
    args, ren_off, out_off = _staged([cut])
    _out, used, status = B3.rans0_decode(*args, int(out_off[-1]))
    assert status.tolist() == [6] and int(used[0]) > ren_off[-1]


@pytest.mark.parametrize("impl", ["native", "python"])
def test_encoders_byte_identical_to_reference(impl, monkeypatch):
    if impl == "python":
        def no_native(*_a, **_k):
            raise ImportError("native encoder disabled for this test")

        import disq_tpu.native as ref_native
        import disq_tpu_torch.native as port_native

        for mod in (ref_native, port_native):
            monkeypatch.setattr(mod, "rans_encode0_native", no_native)
            monkeypatch.setattr(mod, "rans_encode1_native", no_native)
    raws = [b"", b"x", _markov(3000, 8), _quals(5000, 9),
            np.random.default_rng(10).integers(0, 256, 3000,
                                               dtype=np.uint8).tobytes()]
    for raw in raws:
        assert port_rans.rans_encode_order0(raw) == \
            ref_rans.rans_encode_order0(raw)
        assert port_rans.rans_encode_order1(raw) == \
            ref_rans.rans_encode_order1(raw)
        for enc in (port_rans.rans_encode_order0(raw),
                    port_rans.rans_encode_order1(raw)):
            assert port_rans.rans_decode(enc) == raw


def test_decode_routes_by_device(monkeypatch):
    raw = _markov(2000, 7)
    enc = port_rans.rans_encode_order0(raw)
    calls = []
    for mod, name in ((B3, "rans0_decode_simd"), (B5, "rans0_decode_device")):
        real = getattr(mod, name)

        def spy(streams, device, bad=None, *, _real=real, _name=name):
            device = torch.device(device)
            calls.append((_name, device.type))
            if device.type == "cuda":   # no card here: stand in for it
                return [port_rans.rans_decode(s) for s in streams]
            return _real(streams, device, bad)

        monkeypatch.setattr(mod, name, spy)
    counters.reset()
    # rans_decode is the host codec; it never reaches a kernel
    assert port_rans.rans_decode(enc) == raw
    assert calls == []
    # the batched route: B3 by default, B5 under the legacy knob, the
    # plain versions on the CPU
    assert port_rans.rans0_decode_streams([enc], "cuda") == [raw]
    assert port_rans.rans0_decode_streams([enc, enc], CPU) == [raw, raw]
    monkeypatch.setenv("DISQ_TPU_TORCH_DEVICE_RANS", "legacy")
    assert port_rans.rans0_decode_streams([enc], "cuda") == [raw]
    assert port_rans.rans0_decode_streams([enc], CPU) == [raw]
    assert calls == [("rans0_decode_simd", "cuda"), ("rans0_decode_simd", "cpu"),
                     ("rans0_decode_device", "cuda"),
                     ("rans0_decode_device", "cpu")]
    # host decodes: the host call and the two cuda stand-ins
    assert counters.snapshot()["host_rans_streams"] == {"rans0": 3}
    # the CPU route runs the plain versions: no kernel launch is booked
    assert counters.snapshot()["launches"] == {}


def test_wrappers_reject_wrong_dtypes_shapes_and_devices():
    args, _ren_off, out_off = _staged(_encode([b"abc", b"hello"]))
    total = int(out_off[-1])
    ren, ren_off, o_off, states, freq = args
    bad = [
        (ren.to(torch.int32), ren_off, o_off, states, freq),
        (ren, ren_off.to(torch.int32), o_off, states, freq),
        (ren, ren_off, o_off, states.to(torch.int64), freq),
        (ren, ren_off, o_off, states, freq[:, :255].contiguous()),
        (ren, ren_off, o_off[:-1], states, freq),
        (ren, ren_off, o_off, states.t(), freq),
        (ren, ren_off.to("meta"), o_off, states, freq),
        tuple(a.to("meta") for a in args),
    ]
    for fn in (B3.rans0_decode, B5.rans0_decode_legacy):
        for case in bad:
            with pytest.raises(ValueError):
                fn(*case, total)
