"""Port parity: capture files, manifests, the native ingest library, the
liquid-dsp table bridge and the ARB32OPT table loader.

Files are held byte for byte: what the port writes the JAX package
reads, and the reverse.  The native readers are held equal, array for
array, to the JAX package's on the same file and the same socket feed.
"""

import json
import socket
import threading

import numpy as np
import pytest

from rub_mimo_tpu.io import capture as jcapio
from rub_mimo_tpu.io import native as jnative
from rub_mimo_tpu.ofdm import constellation as jconst
from rub_mimo_tpu.ofdm import liquid_tables as jliquid
from rub_mimo_tpu_torch.io import capture as capio
from rub_mimo_tpu_torch.io import native
from rub_mimo_tpu_torch.ofdm import constellation, liquid_tables
import torch_oracle as oracle


def _iq(seed, shape, scale=0.5):
    rng = np.random.default_rng(seed)
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _bytes(directory, names):
    return {n: (directory / n).read_bytes() for n in names}


@pytest.mark.parametrize("wire_format", ["fc32", "sc16"])
def test_capture_files_interchange(tmp_path, wire_format):
    """The port's capture files equal the JAX package's byte for byte,
    and each package reads the other's."""
    x = _iq(0, (2, 1000), scale=0.2)  # within sc16's full scale
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    capio.write_capture(ours, x, prefix="rx", wire_format=wire_format)
    jcapio.write_capture(theirs, x, prefix="rx", wire_format=wire_format)
    names = ["rx1.dat", "rx2.dat"]
    assert _bytes(ours, names) == _bytes(theirs, names)
    a = capio.read_capture(theirs, 2, wire_format=wire_format)
    b = jcapio.read_capture(ours, 2, wire_format=wire_format)
    np.testing.assert_array_equal(a, b)
    if wire_format == "fc32":
        np.testing.assert_array_equal(a, x)
    else:
        np.testing.assert_allclose(a, x, atol=1.0 / 32767.0)


def test_capture_cut_to_shortest_stream(tmp_path):
    capio.write_iq(tmp_path / "rx1.dat", _iq(1, 50))
    capio.write_iq(tmp_path / "rx2.dat", _iq(2, 40))
    got = capio.read_capture(tmp_path, 2)
    np.testing.assert_array_equal(got, jcapio.read_capture(tmp_path, 2))
    assert got.shape == (2, 40)
    with pytest.raises(FileNotFoundError):
        capio.read_capture(tmp_path, 3)
    with pytest.raises(ValueError, match="wire_format"):
        capio.read_capture(tmp_path, 2, wire_format="sc8")


def test_data_and_metric_files_interchange(tmp_path):
    d = np.random.default_rng(3).integers(0, 32, 500).astype(np.int32)
    m = np.random.default_rng(4).random(300).astype(np.float32)
    capio.write_data(tmp_path / "a.dat", d)
    jcapio.write_data(tmp_path / "b.dat", d)
    capio.write_metric(tmp_path / "c.dat", m)
    jcapio.write_metric(tmp_path / "d.dat", m)
    assert (tmp_path / "a.dat").read_bytes() == (tmp_path / "b.dat").read_bytes()
    assert (tmp_path / "c.dat").read_bytes() == (tmp_path / "d.dat").read_bytes()
    np.testing.assert_array_equal(capio.read_data(tmp_path / "b.dat"), d)
    np.testing.assert_array_equal(capio.read_metric(tmp_path / "d.dat"), m)
    x = _iq(5, 64)
    capio.write_iq(tmp_path / "e.dat", x)
    np.testing.assert_array_equal(jcapio.read_iq(tmp_path / "e.dat", 10, 5),
                                  capio.read_iq(tmp_path / "e.dat", 10, 5))


def test_manifest_interchange(tmp_path):
    """A manifest saved by the port equals the JAX package's byte for
    byte and loads there, and the reverse; the port refuses a JAX
    config."""
    dev = {"type": "b200", "serial": "308F965"}
    ours = capio.CaptureManifest(config=oracle.PTINY, num_samples=1234,
                                 description="test", device=dev)
    theirs = jcapio.CaptureManifest(config=oracle.TINY, num_samples=1234,
                                    description="test", device=dev)
    ours.save(tmp_path / "p.json")
    theirs.save(tmp_path / "j.json")
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    back = capio.CaptureManifest.load(tmp_path / "j.json")
    assert back == ours
    assert jcapio.CaptureManifest.load(tmp_path / "p.json") == theirs
    with pytest.raises(TypeError, match="config_from_jax"):
        capio.CaptureManifest(config=oracle.TINY, num_samples=1).save(
            tmp_path / "x.json")


@pytest.mark.parametrize("case", ["good", "nan", "zeros", "short", "empty"])
def test_validate_capture_matches_jax(case):
    x = {"good": np.ones((2, 100), np.complex64),
         "nan": np.where(np.arange(100) == 7, np.nan, 1.0).astype(
             np.complex64)[None].repeat(2, 0),
         "zeros": np.zeros((2, 10), np.complex64),
         "short": _iq(6, (2, 30)),
         "empty": np.zeros((2, 0), np.complex64)}[case]
    for min_len in (None, 50):
        assert capio.validate_capture(x, min_len) == \
            jcapio.validate_capture(x, min_len)


def test_native_library_builds_into_the_port():
    assert native.available()
    assert native.library_path().exists()
    assert native.library_path().parent.name == "_build"


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "numpy"])
def test_sc16_and_validate_match_jax(native_on, monkeypatch):
    """sc16 <-> fc32 and the validation scan equal the JAX package's,
    through the native library and through the numpy fallback (the
    JAX package's own fallback beside it)."""
    if not native_on:
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    x = _iq(7, 2001, scale=1.5)  # some samples clamp
    raw = native.fc32_to_sc16(x)
    np.testing.assert_array_equal(raw, jnative.fc32_to_sc16(x))
    np.testing.assert_array_equal(native.sc16_to_fc32(raw),
                                  jnative.sc16_to_fc32(raw))
    # a truncated capture: the trailing half sample is dropped
    np.testing.assert_array_equal(native.sc16_to_fc32(raw[:-1]),
                                  jnative.sc16_to_fc32(raw[:-1]))
    bad = x.copy()
    bad[9] = np.nan
    for y in (x, bad):  # the fallbacks' peak of a NaN capture is NaN
        np.testing.assert_equal(native.validate_fc32(y),
                                jnative.validate_fc32(y))


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "numpy"])
def test_stream_reader_matches_jax(tmp_path, native_on, monkeypatch):
    if not native_on:
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    x = _iq(8, 10000)
    p = tmp_path / "cap.dat"
    x.tofile(p)
    with native.StreamReader(p, block_samples=1024, n_buffers=3) as r:
        ours = list(r)
    with jnative.StreamReader(p, block_samples=1024, n_buffers=3) as r:
        theirs = list(r)
    assert len(ours) == len(theirs) == 10
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        native.StreamReader(tmp_path / "missing.dat")


def _socket_blocks(module, x: np.ndarray):
    """Every block a SocketReader of ``module`` yields for x sent in
    unaligned writes of 3001 bytes."""
    r = module.SocketReader(port=0, block_samples=512, n_buffers=4)

    def send():
        with socket.create_connection(("127.0.0.1", r.port)) as s:
            raw = x.tobytes()
            for i in range(0, len(raw), 3001):
                s.sendall(raw[i:i + 3001])

    t = threading.Thread(target=send)
    t.start()
    try:
        blocks = list(r)
    finally:
        t.join(timeout=60)
        r.close()
    assert not t.is_alive()
    return np.concatenate(blocks)


def test_socket_reader_matches_jax():
    x = _iq(9, 5000)
    ours = _socket_blocks(native, x)
    np.testing.assert_array_equal(ours, _socket_blocks(jnative, x))
    np.testing.assert_array_equal(ours, x)


def test_socket_reader_needs_the_library(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="unavailable"):
        native.SocketReader(port=0)


@pytest.fixture
def restore_tables():
    yield
    constellation.set_arb32opt_table(None)
    jconst.set_arb32opt_table(None)


@pytest.fixture(scope="module")
def mock_libliquid(tmp_path_factory):
    """The mock libliquid of tests/test_liquid_tables.py, compiled."""
    import shutil
    import subprocess

    from test_liquid_tables import MOCK_C

    cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("g++")
    if cc is None:
        pytest.skip("no C compiler")
    d = tmp_path_factory.mktemp("mockliquid")
    (d / "mock_liquid.c").write_text(MOCK_C)
    so = d / "libliquid_mock.so"
    subprocess.run([cc, "-shared", "-fPIC", "-O2", "-o", str(so),
                    str(d / "mock_liquid.c")], check=True)
    return str(so)


def test_liquid_bridge_matches_jax(mock_libliquid, restore_tables):
    from rub_mimo_tpu_torch.config import Modulation

    pts = liquid_tables.extract_modem_table("arb32opt", mock_libliquid)
    ref = jliquid.extract_modem_table("arb32opt", mock_libliquid)
    assert pts.dtype == np.complex64
    assert np.array_equal(pts.view(np.float32), ref.view(np.float32))
    with pytest.raises(liquid_tables.LiquidNotFound):
        liquid_tables.extract_modem_table("nonsense", mock_libliquid)
    installed = liquid_tables.install_liquid_arb32opt(mock_libliquid)
    np.testing.assert_array_equal(installed, ref)
    np.testing.assert_array_equal(constellation.table(Modulation.ARB32OPT),
                                  ref)
    # the device copy follows the installed table
    np.testing.assert_array_equal(
        constellation.table_on(Modulation.ARB32OPT, "cpu").numpy(), ref)


def test_liquid_not_found_is_clean():
    with pytest.raises(liquid_tables.LiquidNotFound):
        liquid_tables._open_libliquid("/nonexistent/libliquid.so")
    assert issubclass(liquid_tables.LiquidNotFound, RuntimeError)


@pytest.mark.parametrize("fmt", ["npy_complex", "npy_pairs", "json", "txt"])
def test_load_arb32opt_table_matches_jax(tmp_path, fmt, restore_tables):
    from rub_mimo_tpu_torch.config import Modulation

    pts = _iq(10, 32)
    pairs = np.stack([pts.real, pts.imag], axis=-1).astype(np.float64)
    path = tmp_path / {"npy_complex": "t.npy", "npy_pairs": "t.npy",
                       "json": "t.json", "txt": "t.txt"}[fmt]
    if fmt == "npy_complex":
        np.save(path, pts)
    elif fmt == "npy_pairs":
        np.save(path, pairs)
    elif fmt == "json":
        path.write_text(json.dumps(pairs.tolist()))
    else:
        np.savetxt(path, pairs)
    ours = constellation.load_arb32opt_table(path)
    theirs = jconst.load_arb32opt_table(path)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(constellation.table(Modulation.ARB32OPT),
                                  theirs)
    np.testing.assert_array_equal(
        constellation.table_on(Modulation.ARB32OPT, "cpu").numpy(), theirs)
    np.save(tmp_path / "bad.npy", pts[:31])
    with pytest.raises(ValueError, match="32 points"):
        constellation.load_arb32opt_table(tmp_path / "bad.npy")
