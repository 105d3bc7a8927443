"""The port's host-side applications against the JAX package's:
``format_sctype`` and ``msequence_bits``, the device registry
(io/devices.py; registries written by either package read in the
other), ``analyze`` on the artifacts of either package's ``cli run
--log-dir``, the figures (``plot_run``, ``report_html.render``, where
matplotlib is installed) and the live view driven by the port's
streaming decoder on the CPU (tests/test_live_view.py's assertions),
with ``live_view``'s replay command."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rub_mimo_tpu.apps import analyze as janalyze
from rub_mimo_tpu.apps import cli as jcli
from rub_mimo_tpu.io import devices as jdevices
from rub_mimo_tpu.ofdm import lfsr as jlfsr
from rub_mimo_tpu.ofdm import sctype as jsctype
from rub_mimo_tpu_torch.apps import analyze, cli, live_view, report_html
from rub_mimo_tpu_torch.config import ModemConfig, Modulation, tiny_config
from rub_mimo_tpu_torch.io import capture as capio
from rub_mimo_tpu_torch.io import devices, simulator
from rub_mimo_tpu_torch.ofdm import lfsr, sctype
from rub_mimo_tpu_torch.pipeline import streaming

RUN = ["run", "--cpu", "--num_subcarriers", "64", "--cp_len", "16",
       "--num_access_codes", "4", "--frames", "8", "--modulation", "qpsk",
       "--snr", "35", "--delay", "300", "-q"]


# ------------------------------------------------- sctype and m-sequences
@pytest.mark.parametrize("M,use_all,add_null", [
    (64, True, True), (64, False, True), (64, False, False),
    (2048, True, True), (2048, False, True), (128, False, False)])
def test_format_sctype_matches_jax(M, use_all, add_null):
    p = sctype.init_default_sctype(M, use_all_carriers=use_all,
                                   add_null_carriers=add_null)
    want = jsctype.format_sctype(jsctype.init_default_sctype(
        M, use_all_carriers=use_all, add_null_carriers=add_null))
    assert sctype.format_sctype(p) == want
    assert want.startswith("[") and len(want) == M + 2


@pytest.mark.parametrize("m,g,a,n", [
    (13, 0x2011, 1, 5000), (13, 0x201b, 1, 300), (6, 0x43, 3, 200),
    (3, 0xb, 1, 20)])
def test_msequence_bits_matches_jax(m, g, a, n):
    got = lfsr.msequence_bits(m, g, a, n)
    assert isinstance(got, tuple)
    assert got == jlfsr.msequence_bits(m, g, a, n)
    assert lfsr.msequence_bits(m, g, a, n) is got  # cached


# ------------------------------------------------------ device registry
def test_parse_addr_string():
    d = devices.Device.from_addr_string(
        "type=b200,serial=308F955,product=B210,name=MyB210")
    assert (d.type, d.serial, d.product, d.name) == ("b200", "308F955",
                                                     "B210", "MyB210")
    assert d.subdev_spec_tx == "A:B A:A"  # B210 spec (config.h:47)
    assert d.subdev_spec_rx == "A:A A:B"
    j = jdevices.Device.from_addr_string(
        "type=b200,serial=308F955,product=B210,name=MyB210")
    assert d.to_dict() == j.to_dict()


def test_subdev_specs_per_model():
    assert devices.SUBDEV_SPECS == jdevices.SUBDEV_SPECS
    assert devices.SUBDEV_SPECS["x300"]["tx"] == "A:0 B:0"
    assert devices.SUBDEV_SPECS["usrp2"]["rx"] == "A:0"
    assert devices.Device(type="x300").subdev_spec_rx == "A:0 B:0"
    assert devices.Device(type="unknown").subdev_spec_tx == "A:0"


def test_registry_round_trip_both_ways(tmp_path):
    devs = devices.find_devices()
    assert len(devs) == 6  # the reference lab's radios (config.h:37-42)
    assert any(d.serial == "308F965" for d in devs)
    devices.save_registry(devs, tmp_path / "port.json")
    back = devices.load_registry(tmp_path / "port.json")
    assert [d.name for d in back] == [d.name for d in devs]
    # the port's registry read by the JAX package, and the other way
    assert [d.to_dict() for d in jdevices.load_registry(
        tmp_path / "port.json")] == [d.to_dict() for d in devs]
    jdevices.save_registry(jdevices.find_devices(), tmp_path / "jax.json")
    assert (tmp_path / "jax.json").read_text() == \
        (tmp_path / "port.json").read_text()
    assert [d.to_dict() for d in devices.find_devices(
        tmp_path / "jax.json")] == [d.to_dict() for d in devs]


# ------------------------------------------------------------- analyze
@pytest.fixture(scope="module")
def log_dirs(tmp_path_factory):
    """The artifact sets of `run --log-dir` by the port's CLI and by the
    JAX package's, on the same tiny geometry."""
    d = tmp_path_factory.mktemp("logs")
    assert cli.main([*RUN, "--log-dir", str(d / "port")]) == 0
    assert jcli.main([*RUN, "--log-dir", str(d / "jax")]) == 0
    return d


def _same_stats(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_analyze_matches_jax(log_dirs, writer):
    d = log_dirs / writer
    art, jart = analyze.load(d, 2), janalyze.load(d, 2)
    for f in ("tx", "rx", "f_sc", "tx_sig", "rx_sig", "tx_data", "rx_data"):
        a, b = getattr(art, f), getattr(jart, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert sorted(art.corr) == sorted(jart.corr)
    for k in art.corr:
        np.testing.assert_array_equal(art.corr[k], jart.corr[k])
    stats = analyze.analyze(art, 64)
    _same_stats(stats, janalyze.analyze(jart, 64))
    assert stats["ser"].tolist() == [0.0, 0.0]
    assert analyze.analyze(analyze.RunArtifacts(), 64) == {}


def test_analyze_main_prints_the_ser(log_dirs, capsys):
    assert analyze.main([str(log_dirs / "port")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["stream 0: SER 0.0000%  (0 errors)",
                   "stream 1: SER 0.0000%  (0 errors)"]


def test_plot_run_and_html_report(log_dirs, tmp_path):
    pytest.importorskip("matplotlib")
    cfg = ModemConfig(num_subcarriers=64, cp_len=16, num_access_codes=4,
                      pid_max=8, modulation=Modulation.QPSK)  # RUN's
    fig = analyze.plot_run(log_dirs / "port", cfg, out_path=tmp_path / "f.png")
    assert (tmp_path / "f.png").stat().st_size > 0 and fig is not None
    out = report_html.render(log_dirs / "port", cfg, tmp_path / "r.html",
                             report_json='{"synced": true}')
    doc = out.read_text()
    assert doc.startswith("<!DOCTYPE html>") and "data:image/png;base64," in doc
    assert "&quot;synced&quot;: true" in doc and "0.0000%" in doc


# ----------------------------------------------------------- live view
def _get(port: int, path: str):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=5).read()


def test_live_view_serves_and_updates():
    cfg = tiny_config(bit_exact=False)
    view = live_view.LiveView(cfg, port=0)  # ephemeral port
    port = view.start()
    try:
        assert "constellation" in _get(port, "/").decode()
        d0 = json.loads(_get(port, "/data.json"))
        assert d0["n_frames"] == 0 and d0["phase"] == "seek"

        # chunks of 1,024, under tiny_config's frame (ROADMAP queue 3)
        spec = simulator.ChannelSpec(snr_db=35.0, delay=501, seed=11)
        cap, tx_data, _ = simulator.simulate_capture(cfg, spec, device="cpu")
        dec = streaming.StreamingDecoder(cfg, device="cpu", chunk_size=1024)
        T = cap.shape[-1]
        nc = -(-T // 1024)
        padded = torch.nn.functional.pad(cap, (0, nc * 1024 - T))
        for i in range(nc):
            out = dec.push(padded[:, i * 1024:(i + 1) * 1024])
            view.add_frames(out)  # tensors: one copy a push
            view.set_status(phase=dec.phase, synced=bool(dec.synced),
                            sync_index=dec.sync_index)
        dec.finalize()
        view.set_status(phase="done", synced=bool(dec.synced))

        d1 = json.loads(_get(port, "/data.json"))
        assert d1["synced"] is True
        assert d1["n_frames"] == cfg.pid_max
        assert d1["phase"] == "done"
        assert d1["sync_index"] == dec.sync_index
        assert len(d1["constellations"]) == cfg.num_streams
        assert len(d1["constellations"][0]) > 0
        assert len(d1["time"][0]) == 2 * min(cfg.M_occupied, 512)
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/nope")
        assert e.value.code == 404
    finally:
        view.stop()


def test_live_view_takes_numpy_frames_as_the_jax_view():
    """The same frames as numpy arrays or as tensors give the JAX view's
    snapshot."""
    from rub_mimo_tpu.apps.live_view import LiveView as JaxView

    cfg = tiny_config(bit_exact=False)
    rng = np.random.default_rng(5)
    frames = [(k, (rng.standard_normal((2, 64)) + 1j * rng.standard_normal(
        (2, 64))).astype(np.complex64)) for k in range(90)]
    a, b, c = (live_view.LiveView(cfg, max_points=1000),
               live_view.LiveView(cfg, max_points=1000),
               JaxView(cfg, max_points=1000))
    for i in range(0, 90, 7):
        a.add_frames(frames[i:i + 7])
        b.add_frames([(k, torch.as_tensor(f)) for k, f in frames[i:i + 7]])
        c.add_frames(frames[i:i + 7])
    assert a.snapshot_json() == b.snapshot_json() == c.snapshot_json()


def test_live_view_replays_a_capture(tmp_path, capsys):
    cfg = tiny_config(bit_exact=False)
    spec = simulator.ChannelSpec(snr_db=35.0, delay=501, seed=11)
    cap, tx_data, _ = simulator.simulate_capture(cfg, spec, device="cpu")
    capio.write_capture(tmp_path, cap.numpy())
    capio.CaptureManifest(cfg, cap.shape[-1]).save(tmp_path / "manifest.json")
    args = [str(tmp_path), "--cpu", "--once", "--port", "0", "--rate", "0",
            "--chunk", "1024"]
    assert live_view.main(args) == 0
    out = capsys.readouterr().out
    assert f"frames={cfg.pid_max}" in out and "synced=True" in out
    view = live_view.LiveView(cfg)
    dec, shown = live_view.replay(view, cap, cfg, device="cpu",
                                  chunk_size=1024)
    assert sorted(shown) == list(range(cfg.pid_max))
    rx_sig = torch.stack([shown[k] for k in range(cfg.pid_max)], dim=1)
    from rub_mimo_tpu_torch.ofdm import constellation
    got = constellation.demodulate(rx_sig.reshape(2, -1), cfg.modulation)
    np.testing.assert_array_equal(got.numpy(), np.asarray(tx_data))
    if not torch.cuda.is_available():
        assert live_view.main(args[:1] + ["--once"]) == 2
        assert "--cpu" in capsys.readouterr().err
