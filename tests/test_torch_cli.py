"""The port's command line (rub_mimo_tpu_torch/apps/cli.py) on the CPU:
run's report, transmit -> decode against the JAX package's CLI, the
coded, file, precoded, checkpoint and front-end branches, a send/listen
pair of processes, and the refusal to run without CUDA or --cpu."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rub_mimo_tpu.apps import cli as jcli
from rub_mimo_tpu.pipeline import checkpoint as jcheckpoint
from rub_mimo_tpu.pipeline import report as jreport
from rub_mimo_tpu_torch.apps import cli
from rub_mimo_tpu_torch.io import capture as capio
from rub_mimo_tpu_torch.io import native, simulator
from rub_mimo_tpu_torch.pipeline import checkpoint

REPO = Path(__file__).resolve().parent.parent
DIMS = ["--num_subcarriers", "64", "--cp_len", "16", "--num_access_codes",
        "4", "--frames", "8", "--modulation", "qpsk"]
CPU = ["--cpu", *DIMS]
RUN = ["run", *CPU, "--snr", "35", "--delay", "300"]


def _sers(out: str) -> list:
    return [float(line.split(":")[1].strip().rstrip("%"))
            for line in out.splitlines() if "symbol error rate" in line]


def test_run_report_fields(capsys, tmp_path):
    """--json prints the JAX package's ExperimentReport fields, synced
    with SER 0; --log-dir writes the artifact set."""
    assert cli.main([*RUN, "--json", "--log-dir", str(tmp_path)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert list(rep) == [f.name for f in
                         jreport.ExperimentReport.__dataclass_fields__
                         .values()]
    assert rep["synced"] and rep["symbol_error_rate"] == [0.0, 0.0]
    assert rep["frames_decoded"] == 8 and rep["num_occupied_carriers"] == 64
    assert rep["samples_processed"] > 0 and rep["decode_seconds"] > 0
    assert (tmp_path / "rx_sig1.dat").exists()
    assert (tmp_path / "f_sc_2.dat").exists()


def test_transmit_then_decode_matches_jax_cli(capsys, tmp_path):
    """transmit writes the TX files and manifest; their signal through a
    simulated channel, decoded by the port's `decode` and by the JAX
    package's, gives equal decisions, SER 0."""
    assert cli.main(["transmit", *CPU, str(tmp_path), "-q"]) == 0
    man = capio.CaptureManifest.load(tmp_path / "manifest.json")
    tx = capio.read_capture(tmp_path, 2, prefix="tx")
    assert man.prefix == "tx" and man.num_samples == tx.shape[-1]
    spec = simulator.ChannelSpec(snr_db=35.0, delay=300, seed=8)
    rx_cap = simulator.apply_channel(
        torch.as_tensor(tx), simulator.draw_channel(spec, 2, 2), spec)
    capio.write_capture(tmp_path, rx_cap.numpy(), prefix="rx")
    capsys.readouterr()
    args = ["decode", *CPU, str(tmp_path), "--tx-data", str(tmp_path)]
    assert cli.main([*args, "--log-dir", str(tmp_path / "port")]) == 0
    assert _sers(capsys.readouterr().out) == [0.0, 0.0]
    assert jcli.main([*args, "--log-dir", str(tmp_path / "jax")]) == 0
    for s in (1, 2):
        name = f"rx_data{s}.dat"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    assert cli.main(["decode", *CPU, str(tmp_path / "missing")]) == 2


@pytest.mark.parametrize("rate", ["1/2", "3/4"])
def test_run_coded(capsys, rate):
    assert cli.main([*RUN, "--fec", "conv_k7", "--fec-rate", rate,
                     "-q"]) == 0
    assert cli.main([*RUN, "--fec", "conv_k7", "--fec-rate", rate]) == 0
    out = capsys.readouterr().out
    bers = [line for line in out.splitlines() if "coded BER" in line]
    assert len(bers) == 2 and all(b.endswith(": 0.000000%") for b in bers)


def test_run_send_file(capsys, tmp_path):
    data = np.random.default_rng(5).integers(0, 256, 40,
                                             dtype=np.uint8).tobytes()
    (tmp_path / "in.bin").write_bytes(data)
    assert cli.main([*RUN, "--send-file", str(tmp_path / "in.bin"),
                     "--recv-out", str(tmp_path / "out.bin")]) == 0
    assert "crc_ok=True, exact=True" in capsys.readouterr().out
    assert (tmp_path / "out.bin").read_bytes() == data


def test_run_precoded_and_checkpoint(capsys, tmp_path):
    """Both rounds decode with SER 0; the checkpoint loads in both
    packages and resumes to the decode's decisions."""
    ck = tmp_path / "run.npz"
    assert cli.main([*RUN, "--precoded", "--save-checkpoint", str(ck)]) == 0
    out = capsys.readouterr().out
    assert "---- precoded round ----" in out
    assert _sers(out) == [0.0] * 4
    ours, theirs = checkpoint.load(ck), jcheckpoint.load(ck)
    assert ours.synced and theirs.synced
    assert ours.sync_index == theirs.sync_index
    cap, _, _ = simulator.simulate_capture(
        ours.config, simulator.ChannelSpec(snr_db=35.0, delay=300, seed=42),
        payload_seed=42, device="cpu")
    _, data = checkpoint.resume_decode(cap, ours, device="cpu")
    np.testing.assert_array_equal(data.numpy(), ours.rx_data)


def test_run_frontend_comp(capsys):
    """tests/test_frontend.py's impairment spoils the 64-QAM decode;
    --frontend-comp restores it."""
    imp = ["--modulation", "qam64", "--frames", "32", "--sync-fallback",
           "--iq-imbalance", "1.0,5.0", "--dc-offset", "0.05"]
    sers = {}
    for fe in (False, True):
        assert cli.main([*RUN, *imp] + (["--frontend-comp"] if fe
                                        else [])) == 0
        sers[fe] = _sers(capsys.readouterr().out)
    assert min(sers[False]) > 50.0 and max(sers[True]) < 2.0, sers


def test_refusals(capsys):
    """Without --cpu on a machine with no CUDA the CLI exits 2 naming
    --cpu (no CPU fallback); a bad --iq-imbalance is a usage error."""
    if not torch.cuda.is_available():
        assert cli.main(["run", *DIMS]) == 2
        assert "--cpu" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        cli.main([*RUN, "--iq-imbalance", "1.0"])
    assert e.value.code == 2
    assert cli.main([*RUN, "--num_subcarriers", "100"]) == 2
    assert "invalid configuration" in capsys.readouterr().err


def test_send_listen_pair(tmp_path):
    """`listen` (the streaming decoder on the native SocketReader) decodes
    what `send` streams from a recorded capture directory, SER 0; both
    are processes of their own."""
    assert native.available()
    assert cli.main([*RUN, "--delay", "501", "-q", "--log-dir",
                     str(tmp_path)]) == 0
    listen = subprocess.Popen(
        [sys.executable, "-m", "rub_mimo_tpu_torch.apps.cli", "listen",
         *CPU, "--chunk", "512", "--tx-data", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO)
    try:
        line = ""
        for _ in range(20):  # skip warnings on the merged stderr
            line = listen.stdout.readline()
            if "listening on" in line or not line:
                break
        assert "listening on" in line, line
        port = line.split(":")[1].split()[0]
        send = subprocess.run(
            [sys.executable, "-m", "rub_mimo_tpu_torch.apps.cli", "send",
             *DIMS, str(tmp_path), "--port", port],
            capture_output=True, text=True, timeout=240, cwd=REPO)
        assert send.returncode == 0, send.stdout + send.stderr
        out, _ = listen.communicate(timeout=240)
    finally:
        if listen.poll() is None:
            listen.kill()
            listen.communicate()
    assert listen.returncode == 0, out
    assert "synced=True" in out, out
    assert _sers(out) == [0.0, 0.0], out
