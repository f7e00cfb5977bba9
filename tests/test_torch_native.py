"""The port's native library (gnsstpu_torch.native) against the
reference's (gnsstpu.native) and the NumPy twins, on the CPU.

One library is built from the three C++ sources that are the reference's
byte for byte (tests/test_torch_copies.py guards them): the threaded
sample codecs, the wire-format packer and the GP2021 integer correlator
golden model, beside the ring FIFO. Each is held bit-identical to the
reference's on the same seeded inputs: the codecs and FileSource reads
(the threaded path included), ops/unpack.pack in every wire format, and
Gp2021Channel's state and dumps across run calls, with max_dumps
truncation, and with a state carried over from the reference's channel.
Without a compiler the port behaves as the reference does: the codecs and
the packer give NumPy's output, and the FIFO and the golden model raise.
"""

import numpy as np
import pytest

from gnsstpu import native as jnative
from gnsstpu.ops import unpack as jup
from gnsstpu.runtime import sources as jsrc
from gnsstpu_torch import native as tnative
from gnsstpu_torch.ops import nco as tnco
from gnsstpu_torch.ops import unpack as tup
from gnsstpu_torch.ops import wire
from gnsstpu_torch.runtime import sources as tsrc
from gnsstpu_torch.signals.gps_l1ca import generate_ca_code
from torch_port import (  # noqa: F401
    one_torch_thread_per_worker, reference_native_library)

# 2**18 samples take the codecs' threaded path (threads split n >= 2**16).
SIZES = (1000, 1 << 18)
DECODERS = {"decode_i8_iq": lambda r, n: r.integers(-128, 128, 2 * n,
                                                    dtype=np.int8),
            "decode_i16_iq": lambda r, n: r.integers(-2 ** 15, 2 ** 15,
                                                     2 * n, dtype=np.int16),
            "decode_gn3s_2bit": lambda r, n: r.integers(0, 256, n,
                                                        dtype=np.uint8),
            "decode_packed_4bit": lambda r, n: r.integers(
                0, 1 << 16, n // 4, dtype=np.uint16)}


def test_library_built_here():
    assert tnative.available() and jnative.available()
    assert tnative._target().exists()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", sorted(DECODERS))
def test_decoders_match_reference_and_numpy(name, n):
    raw = DECODERS[name](np.random.default_rng(n), n)
    got = getattr(tnative, name)(raw)
    assert got.dtype == np.float32 and got.shape == (n, 2)
    np.testing.assert_array_equal(got, getattr(jnative, name)(raw))
    np.testing.assert_array_equal(got, getattr(wire, name)(raw))


@pytest.mark.parametrize("fmt,dtype,per", [
    ("i8_iq", np.int8, 2), ("i16_iq", np.int16, 2),
    ("gn3s_2bit", np.uint8, 1), ("packed_4bit", np.uint16, 1)])
def test_filesource_reads_match_reference(tmp_path, fmt, dtype, per):
    """FileSource and decode_samples decode through the native codecs:
    unaligned packed_4bit reads, reads past the end and a skip."""
    rng = np.random.default_rng(4)
    info = np.iinfo(dtype)
    raw = rng.integers(info.min, info.max + 1, 2 * 3001 * per, dtype=dtype)
    path = tmp_path / f"{fmt}.bin"
    raw.tofile(path)
    for skip in (0, 3):
        j = jsrc.FileSource(str(path), fmt=fmt, skip_samples=skip)
        t = tsrc.FileSource(str(path), fmt=fmt, skip_samples=skip)
        assert len(t) == len(j)
        for start, count in ((0, 100), (7, 33), (1, 4), (4093, 2000),
                             (len(j) - 5, 40)):
            np.testing.assert_array_equal(t.read(start, count),
                                          j.read(start, count))
    if fmt == "packed_4bit":
        full = tnative.decode_packed_4bit(raw)
        np.testing.assert_array_equal(
            tsrc.FileSource(str(path), fmt=fmt).read(7, 33), full[7:40])
    buf = raw.tobytes()[: 4097]
    np.testing.assert_array_equal(tsrc.decode_samples(buf, fmt),
                                  jsrc.decode_samples(buf, fmt))


def _pack_inputs(n: int) -> np.ndarray:
    """Gaussian I/Q with exact ties and threshold values spliced in:
    round-half-to-even, the clip limits and sm2's |x| >= 1 edge."""
    x = np.random.default_rng(n).normal(0.0, 3.0, (n, 2)).astype(np.float32)
    edges = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 1.0, -1.0, 0.0,
                      -0.0, 7.5, -8.5, 127.5, -127.5, 300.0, -300.0],
                     np.float32)
    x.reshape(-1)[: edges.size] = edges
    return x


@pytest.mark.parametrize("n", (1000, 1 << 18))
@pytest.mark.parametrize("fmt", ["iq8", "iq4", "sm2", "iq1"])
def test_pack_matches_reference(fmt, n):
    x = _pack_inputs(n)
    for scale in (1.0, 0.37):
        got = tup.pack(x, fmt, scale)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jup.pack(x, fmt, scale))
        np.testing.assert_array_equal(got, tnative.pack_wire(x, fmt, scale))
        np.testing.assert_array_equal(got, tup.pack_np(x, fmt, scale))
    with pytest.raises(ValueError):
        tnative.pack_wire(x.reshape(-1), fmt, 1.0)


def test_state_dtype_is_the_references():
    dt = tnative.Gp2021Channel._STATE_DTYPE
    assert dt == jnative.Gp2021Channel._STATE_DTYPE
    # struct Gp2021State: three 4-byte fields, padding, int64 acc[6] at 16.
    assert dt.itemsize == 72
    assert [dt.fields[k][1] for k in dt.names] == [0, 4, 8, 16, 64]


def _channel_inputs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    iq = rng.integers(-128, 128, 2 * n, dtype=np.int8)
    code = generate_ca_code(int(rng.integers(1, 33))).astype(np.int8)
    carr = int(rng.integers(0, 1 << 32))
    code_step = int(round(2 * (1.023e6 + rng.normal(0, 50)) / 2.048e6
                          * 2 ** 32)) & 0xFFFFFFFF
    return iq, code, carr, code_step


def _same_state(a, b) -> None:
    """Field by field: the struct's padding bytes carry no state."""
    for k in a.dtype.names:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gp2021_state_and_dumps_match_reference(seed):
    iq, code, carr, code_step = _channel_inputs(seed, 11_000)
    j = jnative.Gp2021Channel(code, epochs_per_bit=20)
    t = tnative.Gp2021Channel(code, epochs_per_bit=20)
    # Two run calls, the second at other steps and cut mid-epoch.
    for lo, hi, cs, ks in ((0, 4_100, carr, code_step),
                           (4_100, 9_000, carr + 12_345, code_step - 777)):
        dj = j.run(iq[2 * lo: 2 * hi], cs, ks)
        dt = t.run(iq[2 * lo: 2 * hi], cs, ks)
        assert dt.dtype == np.int64 and dt.shape[1] == 6 and len(dt) >= 1
        np.testing.assert_array_equal(dt, dj)
        _same_state(t.state, j.state)
    # max_dumps=0 records nothing; an epoch still clears the accumulators.
    dj = j.run(iq[18_000:], carr, code_step, max_dumps=0)
    dt = t.run(iq[18_000:], carr, code_step, max_dumps=0)
    assert dt.shape == dj.shape == (0, 6)
    _same_state(t.state, j.state)
    # A state carried over from the reference's channel runs on here; at
    # 4x the code rate 10,000 samples hold ~19 epochs, of which 2 are kept.
    k = tnative.Gp2021Channel(code)
    k.state = j.state.copy()
    wide = iq[: 2 * 10_000]
    dk = k.run(wide, carr, 4 * code_step, max_dumps=2)
    dj = j.run(wide, carr, 4 * code_step, max_dumps=2)
    assert len(dk) == 2                    # more epochs than it keeps
    np.testing.assert_array_equal(dk, dj)
    _same_state(k.state, j.state)
    assert int(k.state["epoch_ms"][0]) == int(j.state["epoch_ms"][0]) != 0


def test_gp2021_rejects_a_foreign_state():
    t = tnative.Gp2021Channel(np.ones(1023, np.int8))
    t.state = np.zeros(1, [("carr_phase", np.uint32)])
    with pytest.raises(ValueError):
        t.run(np.zeros(8, np.int8), 1, 1)


def test_gp2021_nco_phase_matches_port_nco():
    """The model's uint32 carrier phase after n steps is n x the port's
    ops.nco step, mod 2^32 (tests/test_native.py:95-110)."""
    ch = tnative.Gp2021Channel(generate_ca_code(1))
    fs = 2.048e6
    carr_step = int(tnco.freq_to_step_u32(9.548e3 + 4.13e5, fs))
    n = 12345
    ch.run(np.zeros(2 * n, np.int8), carr_step, code_step=0, max_dumps=1)
    want = (np.uint64(n) * np.uint64(carr_step)) % np.uint64(2 ** 32)
    assert int(ch.state["carr_phase"][0]) == int(want)


def test_without_a_compiler_behaves_as_the_reference(tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_error", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "none")
    monkeypatch.setenv("CXX", "no-such-c++-compiler")
    assert not tnative.available()
    rng = np.random.default_rng(9)
    for name, make in DECODERS.items():
        raw = make(rng, 4096)
        np.testing.assert_array_equal(getattr(tnative, name)(raw),
                                      getattr(jnative, name)(raw))
    x = _pack_inputs(4096)
    assert tnative.pack_wire(x, "sm2", 1.0) is None
    for fmt in ("iq8", "iq4", "sm2", "iq1"):
        np.testing.assert_array_equal(tup.pack(x, fmt, 0.5),
                                      jup.pack(x, fmt, 0.5))
    for make in (lambda: tnative.RingFifo(4, 16),
                 lambda: tnative.Gp2021Channel(np.ones(1023, np.int8))):
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            make()
