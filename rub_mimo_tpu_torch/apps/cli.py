"""The command line of the PyTorch / CUDA port.

Port of rub_mimo_tpu/apps/cli.py, with the same flags and exit codes:

  run       synthetic end-to-end experiment (TX -> simulated channel ->
            decode -> SER report), the stand-in for the over-the-air run
  decode    decode a recorded capture directory (rx{n}.dat files)
  transmit  generate a TX baseband signal and its ground-truth files
  send      stream a capture directory to a `listen` process over TCP
  listen    decode a live TCP IQ feed with the streaming decoder

    python -m rub_mimo_tpu_torch.apps.cli run [flags]

Every command but `send` runs on the CUDA device; --cpu runs it on the
CPU instead.  Without CUDA and without --cpu the command stops with
exit code 2: nothing falls back to the CPU.  --trace-dir writes a
torch.profiler trace (a Chrome trace, trace.json) and beside it the
program's spans, set-up spans, counters and device marks with each
marked decode's stage µs (spans.json; utils/profiling.py).  The flags mirror the
reference's boost::program_options (mimo/main.cc:174-250); --repeat is
run_exe.sh's loop (mimo/apps/run_exe.sh:1-6).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np


def _iq_imbalance_arg(value: str) -> tuple[float, float]:
    """argparse type for --iq-imbalance: exactly two comma-separated
    floats (amplitude dB, phase degrees); anything else is a usage error
    (exit code 2)."""
    parts = value.split(",")
    try:
        if len(parts) != 2:
            raise ValueError
        return float(parts[0]), float(parts[1])
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected DB,DEG (two comma-separated floats), got {value!r}"
        ) from None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="rub-mimo-tpu-torch",
        description="MIMO-OFDM modem, PyTorch / CUDA port")
    sub = ap.add_subparsers(dest="command", required=True)

    def add_common(p):
        # reference CLI flags (main.cc:174-250)
        p.add_argument("-f", "--freq", type=float, default=2450e6,
                       help="RF center frequency in Hz")
        p.add_argument("-r", "--rate", type=float, default=1.0e6,
                       help="Sampling rate")
        p.add_argument("--dsp_gain", type=float, default=0.25,
                       help="TX DSP (baseband) gain")
        p.add_argument("--tx_gain", type=float, default=67.0)
        p.add_argument("--rx_gain", type=float, default=45.0)
        p.add_argument("--num_subcarriers", type=int, default=2048)
        p.add_argument("--cp_len", type=int, default=152)
        p.add_argument("--num_streams", type=int, default=2)
        p.add_argument("--num_access_codes", type=int, default=20)
        p.add_argument("--frames", type=int, default=1000,
                       help="payload OFDM symbols (PID_MAX)")
        p.add_argument("--modulation", default="arb32opt",
                       choices=["bpsk", "qpsk", "qam16", "qam64", "qam256",
                                "arb32opt"])
        p.add_argument("--detector", default="zf",
                       choices=["zf", "mmse", "ml", "sic"])
        p.add_argument("--mode", default="rx_zf",
                       choices=["siso", "rx_zf", "rx_diversity", "alamouti"])
        p.add_argument("--bit-exact", action="store_true",
                       help="replicate the reference's estimator quirks")
        p.add_argument("--correct-cfo", action="store_true")
        p.add_argument("--sync-fallback", action="store_true",
                       help="S0-xcorr sync fallback for low-SNR captures")
        p.add_argument("--track-phase", action="store_true",
                       help="decision-directed common-phase tracking")
        p.add_argument("--track-channel", action="store_true",
                       help="decision-directed per-subcarrier channel "
                            "tracking (ZF-family modes)")
        p.add_argument("--track-block-frames", type=int, default=16)
        p.add_argument("--track-alpha", type=float, default=0.5)
        p.add_argument("--s1-qpsk", action="store_true",
                       help="QPSK access codes (the reference's "
                            "compiled-out MAKE_S1_QPSK variant, quirks "
                            "replicated)")
        p.add_argument("--same-signal-on-all-tx", action="store_true",
                       help="repeat stream 0's payload on every TX "
                            "antenna (reference's SAME_SIGNAL_ON_ALL_TX "
                            "variant)")
        p.add_argument("--smooth-channel", action="store_true",
                       help="delay-domain denoising of the channel "
                            "estimate (all-carriers allocation)")
        p.add_argument("--config", type=Path, default=None,
                       help="load a ModemConfig JSON (overrides flags)")
        p.add_argument("-v", "--verbose", action="store_true")
        p.add_argument("-q", "--quiet", action="store_true")
        p.add_argument("--cpu", action="store_true",
                       help="run on the CPU (the default device is CUDA)")
        p.add_argument("--log-dir", type=Path, default=None,
                       help="dump the reference's artifact files here")
        p.add_argument("--json", action="store_true",
                       help="print the structured JSON report")
        p.add_argument("--profile", action="store_true",
                       help="print per-stage timings and samples/s")
        p.add_argument("--trace-dir", type=Path, default=None,
                       help="write a torch.profiler trace here "
                            "(trace.json) and the program's spans and "
                            "device marks (spans.json)")
        p.add_argument("--arb32opt-table", type=Path, default=None,
                       help="install an exact external 32-point table "
                            "into the ARB32OPT slot (.npy/.json/.txt; "
                            "e.g. liquid-dsp's arb32opt list for "
                            "symbol-exact parity with reference "
                            "captures)")
        p.add_argument("--arb32opt-from-liquid", action="store_true",
                       help="extract the exact ARB32OPT table from an "
                            "installed liquid-dsp (dlopen libliquid) and "
                            "install it (see "
                            "scripts/extract_liquid_arb32opt.py)")

    p_run = sub.add_parser("run", help="synthetic end-to-end experiment")
    add_common(p_run)
    p_run.add_argument("--snr", type=float, default=30.0)
    p_run.add_argument("--delay", type=int, default=5000)
    p_run.add_argument("--taps", type=int, default=1,
                       help=">1 for a frequency-selective channel")
    p_run.add_argument("--fec", default="none", choices=["none", "conv_k7"],
                       help="forward error correction: rate-1/2 K=7 "
                            "convolutional code with soft Viterbi decoding")
    p_run.add_argument("--fec-rate", default="1/2",
                       choices=["1/2", "2/3", "3/4"],
                       help="802.11a punctured code rate (with --fec)")
    p_run.add_argument("--send-file", type=Path, default=None,
                       help="transmit this file's bytes as the coded "
                            "payload (length + CRC-32 header)")
    p_run.add_argument("--recv-out", type=Path, default=None,
                       help="write the recovered bytes here (--send-file)")
    p_run.add_argument("--drift", type=float, default=0.0,
                       help="per-sample channel drift rate (each H entry "
                            "rotates at drift * u, u ~ U(-1,1))")
    p_run.add_argument("--sfo-ppm", type=float, default=0.0,
                       help="TX/RX sampling-clock offset impairment (ppm)")
    p_run.add_argument("--sfo-correct", action="store_true",
                       help="iterative SFO estimation + band-limited "
                            "resampling correction")
    p_run.add_argument("--iq-imbalance", default=None, metavar="DB,DEG",
                       type=_iq_imbalance_arg,
                       help="RX IQ imbalance impairment: amplitude dB, "
                            "phase degrees (e.g. 1.0,5.0)")
    p_run.add_argument("--dc-offset", type=float, default=0.0,
                       help="RX DC offset impairment (real amplitude)")
    p_run.add_argument("--frontend-comp", action="store_true",
                       help="blind IQ-imbalance + DC compensation before "
                            "decoding")
    p_run.add_argument("--cfo", type=float, default=0.0,
                       help="channel CFO in subcarrier units")
    p_run.add_argument("--seed", type=int, default=42)
    p_run.add_argument("--repeat", type=int, default=1,
                       help="repeat the experiment N times (run_exe.sh)")
    p_run.add_argument("--precoded", action="store_true",
                       help="closed-loop TX beamforming: estimate the "
                            "channel in a first round, ZF-precode a second "
                            "transmission through the same channel")
    p_run.add_argument("--save-checkpoint", type=Path, default=None,
                       help="persist decode state (sync/Ghat/W/symbols)")

    p_dec = sub.add_parser("decode", help="decode a recorded capture dir")
    add_common(p_dec)
    p_dec.add_argument("capture_dir", type=Path)
    p_dec.add_argument("--prefix", default="rx")
    p_dec.add_argument("--tx-data", type=Path, default=None,
                       help="optional tx_data files dir for scoring")

    p_tx = sub.add_parser("transmit", help="generate a TX baseband signal")
    add_common(p_tx)
    p_tx.add_argument("out_dir", type=Path)
    p_tx.add_argument("--seed", type=int, default=0)

    p_snd = sub.add_parser(
        "send",
        help="stream a recorded capture dir to a `listen` process over "
             "TCP (sample-interleaved complex64, like UHD's wire)")
    add_common(p_snd)
    p_snd.add_argument("capture_dir", type=Path)
    p_snd.add_argument("--prefix", default="rx")
    p_snd.add_argument("--host", default="127.0.0.1")
    p_snd.add_argument("--port", type=int, required=True)

    p_ls = sub.add_parser(
        "listen",
        help="decode a live TCP IQ feed (sample-interleaved complex64 "
             "across streams, like UHD's multi-channel wire)")
    add_common(p_ls)
    p_ls.add_argument("--port", type=int, default=0,
                      help="TCP port on 127.0.0.1 (0 = auto-assign)")
    p_ls.add_argument("--chunk", type=int, default=4096,
                      help="streaming chunk size in samples/stream")
    p_ls.add_argument("--tx-data", type=Path, default=None,
                      help="optional tx_data files dir for scoring")
    return ap


def _config_from_args(args):
    from rub_mimo_tpu_torch.config import (CommMode, Detector, ModemConfig,
                                           Modulation)

    if args.config:
        return ModemConfig.from_json(args.config.read_text())
    return ModemConfig(
        num_subcarriers=args.num_subcarriers,
        cp_len=args.cp_len,
        num_streams=args.num_streams,
        num_access_codes=args.num_access_codes,
        pid_max=args.frames,
        modulation=Modulation(args.modulation),
        detector=Detector(args.detector),
        mode=CommMode(args.mode),
        bit_exact=args.bit_exact,
        correct_cfo=args.correct_cfo,
        sync_fallback=args.sync_fallback,
        track_phase=args.track_phase,
        track_channel=args.track_channel,
        track_block_frames=args.track_block_frames,
        track_alpha=args.track_alpha,
        smooth_channel=args.smooth_channel,
        s1_qpsk=args.s1_qpsk,
        same_signal_on_all_tx=args.same_signal_on_all_tx,
        center_frequency=args.freq,
        sample_rate=args.rate,
        baseband_gain=args.dsp_gain,
        tx_gain=args.tx_gain,
        rx_gain=args.rx_gain,
    )


def _device(args):
    """The command's torch device: the CPU with --cpu, else CUDA; None
    when CUDA is not available."""
    import torch

    if args.cpu:
        return torch.device("cpu")
    return torch.device("cuda") if torch.cuda.is_available() else None


def _read_tx_data(directory: Path, cfg) -> np.ndarray:
    from rub_mimo_tpu_torch.io import capture as capio

    return np.stack([capio.read_data(directory / f"tx_data{s + 1}.dat")
                     for s in range(cfg.num_streams)]).astype(np.int32)


def _decode_and_report(cfg, capture, tx_data, args, device):
    import torch

    from rub_mimo_tpu_torch.pipeline import artifacts, report, rx
    from rub_mimo_tpu_torch.utils import profiling

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    dec = rx.make_decoder(cfg, device=device,
                          keep_debug=args.log_dir is not None)
    capture = torch.as_tensor(capture, dtype=torch.complex64, device=device)
    result = dec(capture)
    synchronize()

    if args.profile:
        from rub_mimo_tpu_torch.kernels import sc_metric
        from rub_mimo_tpu_torch.sync import schmidl_cox

        n = capture.numel()
        timer = profiling.StageTimer()
        timer.time_stage("sc_metric",
                         lambda x: sc_metric.sc_metric_fused(x, cfg.M),
                         capture, samples=n, iters=3)
        timer.time_stage("sync_full",
                         lambda x: schmidl_cox.synchronize(x, cfg),
                         capture, samples=n, iters=3)
        timer.time_stage("full_decode", dec, capture, samples=n, iters=3)
        timer.print()

    if args.trace_dir is not None:
        with profiling.trace(str(args.trace_dir)):
            dec(capture)

    t0 = time.perf_counter()
    result = dec(capture)
    synchronize()
    dt = time.perf_counter() - t0

    rep = None
    if tx_data is not None:
        rep = report.score(result, tx_data, cfg, decode_seconds=dt,
                           num_samples=capture.shape[-1])
    if args.log_dir is not None:
        artifacts.dump(args.log_dir, cfg, result, iq=capture,
                       tx_data=tx_data)
    if rep is not None:
        if args.json:
            print(rep.to_json())
        elif not args.quiet:
            rep.print()
    else:
        print(f"    synced                  : {bool(result.synced)}")
        print(f"    sync index              : {int(result.sync_index)}")
        print(f"    decode time             : {dt:.4f}s")
    return result, rep


def _run(cfg, args, device) -> int:
    from rub_mimo_tpu_torch.io import simulator

    iq_amp, iq_phase = args.iq_imbalance or (0.0, 0.0)
    spec = simulator.ChannelSpec(
        snr_db=args.snr, delay=args.delay,
        flat=args.taps <= 1, num_taps=args.taps,
        cfo_subcarriers=args.cfo, seed=args.seed,
        drift_rate=args.drift, sfo_ppm=args.sfo_ppm,
        iq_amp_db=iq_amp, iq_phase_deg=iq_phase,
        dc_offset=args.dc_offset,
    )
    for i in range(args.repeat):
        sp = dataclasses.replace(spec, seed=spec.seed + i)
        msg_bits = txd = sent_data = None
        if args.send_file is not None:
            from rub_mimo_tpu_torch.ofdm import fec

            sent_data = args.send_file.read_bytes()
            txd = fec.encode_data(sent_data, cfg, rate=args.fec_rate)
        elif args.fec != "none":
            from rub_mimo_tpu_torch.ofdm import fec

            msg_bits, txd = fec.encode_payload(cfg, seed=args.seed + i,
                                               rate=args.fec_rate)
        cap, tx_data, h = simulator.simulate_capture(
            cfg, sp, tx_data=txd, payload_seed=args.seed + i, device=device)
        if args.frontend_comp:
            from rub_mimo_tpu_torch.estimate import frontend

            dc, wiq = frontend.estimate_frontend(cap)
            cap = frontend.compensate(cap, dc, wiq)
        if args.sfo_correct:
            from rub_mimo_tpu_torch.estimate import sfo

            try:
                _, dtot, cap = sfo.decode_with_sfo(cap, cfg, device=device)
            except ValueError as e:
                print(f"error: --sfo-correct: {e}", file=sys.stderr)
                return 2
            if not args.quiet:
                print(f"    estimated SFO           : "
                      f"{float(dtot) * 1e6:+.2f} ppm")
        result, _ = _decode_and_report(cfg, cap, tx_data, args, device)
        if sent_data is not None:
            out, ok = fec.decode_data(result, cfg, rate=args.fec_rate)
            exact = out == sent_data
            if not args.quiet:
                print(f"    file transfer           : "
                      f"{len(out)}/{len(sent_data)} bytes, "
                      f"crc_ok={ok}, exact={exact}")
            if args.recv_out is not None:
                args.recv_out.write_bytes(out)
            if not (ok and exact):
                return 1
        if msg_bits is not None:
            if result.Y is not None:
                # ML decode: the joint soft-output lattice LLRs (its
                # remodulated rx_sig would saturate the Viterbi)
                bits = fec.decode_payload_ml(result, cfg, rate=args.fec_rate)
            else:
                bits = fec.decode_payload(result.rx_sig, cfg,
                                          rate=args.fec_rate)
            ber = (bits.cpu().numpy() != msg_bits).mean(axis=1)
            if not args.quiet:
                for lane, b in enumerate(ber):
                    print(f"    coded BER lane {lane}      : "
                          f"{b * 100:.6f}%")
                print(f"    info bits / lane        : {msg_bits.shape[1]}")
        if args.precoded:
            import torch

            from rub_mimo_tpu_torch.detect import precode
            from rub_mimo_tpu_torch.ofdm import framegen, sctype

            occ = sctype.occupied_indices(sctype.allocation(cfg))
            P = precode.zf_precoder(result.G[torch.as_tensor(
                occ, device=result.G.device)])
            tx2_data = framegen.generate_payload_symbols(
                cfg, seed=args.seed + 1000 + i)
            tx2 = framegen.transmit_frame(cfg, tx2_data, device=device,
                                          precoder=P)
            cap2 = simulator.apply_channel(tx2, h, sp, cfg)
            if not args.quiet:
                print("    ---- precoded round ----")
            _decode_and_report(cfg, cap2, tx2_data, args, device)
        if args.save_checkpoint is not None:
            from rub_mimo_tpu_torch.pipeline import checkpoint

            checkpoint.save(args.save_checkpoint, cfg, result)
    return 0


def _transmit(cfg, args, device) -> int:
    from rub_mimo_tpu_torch.io import capture as capio
    from rub_mimo_tpu_torch.ofdm import framegen

    tx_data = framegen.generate_payload_symbols(cfg, seed=args.seed)
    sig = framegen.transmit_frame(cfg, tx_data, device=device).cpu().numpy()
    args.out_dir.mkdir(parents=True, exist_ok=True)
    capio.write_capture(args.out_dir, sig, prefix="tx")
    for s in range(cfg.num_streams):
        capio.write_data(args.out_dir / f"tx_data{s + 1}.dat", tx_data[s])
    capio.CaptureManifest(
        config=cfg, num_samples=sig.shape[-1], prefix="tx",
        description="synthetic TX baseband",
    ).save(args.out_dir / "manifest.json")
    if not args.quiet:
        print(f"wrote {sig.shape} to {args.out_dir}")
    return 0


def _send(cfg, args) -> int:
    import socket

    from rub_mimo_tpu_torch.io import capture as capio

    try:
        cap = capio.read_capture(args.capture_dir, cfg.num_streams,
                                 prefix=args.prefix)
    except FileNotFoundError as e:
        print(f"error: capture not found: {e}", file=sys.stderr)
        return 2
    inter = np.ascontiguousarray(cap.T)  # [T, S]
    try:
        with socket.create_connection((args.host, args.port)) as s:
            s.sendall(inter.tobytes())
    except OSError as e:
        print(f"error: could not send to {args.host}:{args.port}: {e}",
              file=sys.stderr)
        return 2
    if not args.quiet:
        print(f"sent {inter.shape[0]} samples/stream to "
              f"{args.host}:{args.port}")
    return 0


def _listen(cfg, args, device) -> int:
    from rub_mimo_tpu_torch.io import native
    from rub_mimo_tpu_torch.pipeline import streaming

    S = cfg.num_streams
    try:
        reader = native.SocketReader(port=args.port,
                                     block_samples=args.chunk * S)
    except (RuntimeError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"listening on 127.0.0.1:{reader.port} "
          f"({S} streams, chunk {args.chunk})", flush=True)
    dec = streaming.StreamingDecoder(cfg, device=device,
                                     chunk_size=args.chunk)
    n_rx = 0
    with reader:
        for block in reader:
            # a sender may close mid-sample-frame: drop the ragged tail
            n_whole = (block.size // S) * S
            if n_whole == 0:
                continue
            frame = block[:n_whole].reshape(-1, S).T
            chunk = np.zeros((S, args.chunk), np.complex64)
            chunk[:, :frame.shape[1]] = frame
            dec.push(chunk)
            n_rx += frame.shape[1]
    dec.finalize()
    if not args.quiet:
        print(f"stream closed after {n_rx} samples/stream; "
              f"synced={dec.synced}")
    if dec.synced:
        _, rx_data = dec.result()
        rx_data = rx_data.cpu().numpy()
        if args.tx_data is not None:
            tx_data = _read_tx_data(args.tx_data, cfg)
            n = min(tx_data.shape[1], rx_data.shape[1])
            for s in range(S):
                ser = (rx_data[s, :n] != tx_data[s, :n]).mean() * 100
                print(f"    symbol error rate      {s}: {ser:.6f}%")
    elif args.tx_data is not None:
        return 1
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    try:
        cfg = _config_from_args(args).validate()
    except ValueError as e:
        print(f"error: invalid configuration: {e}", file=sys.stderr)
        return 2

    if args.arb32opt_table is not None:
        from rub_mimo_tpu_torch.ofdm import constellation

        try:
            constellation.load_arb32opt_table(args.arb32opt_table)
        except (OSError, ValueError) as e:
            print(f"error: --arb32opt-table: {e}", file=sys.stderr)
            return 2
    elif args.arb32opt_from_liquid:
        from rub_mimo_tpu_torch.ofdm import liquid_tables

        try:
            liquid_tables.install_liquid_arb32opt()
        except liquid_tables.LiquidNotFound as e:
            print(f"error: --arb32opt-from-liquid: {e}", file=sys.stderr)
            return 2

    if args.command == "send":  # moves bytes only: no device
        return _send(cfg, args)
    device = _device(args)
    if device is None:
        print("error: CUDA is not available; pass --cpu to run on the CPU",
              file=sys.stderr)
        return 2
    if args.command == "run":
        return _run(cfg, args, device)
    if args.command == "decode":
        from rub_mimo_tpu_torch.io import capture as capio

        try:
            cap = capio.read_capture(args.capture_dir, cfg.num_streams,
                                     prefix=args.prefix)
        except FileNotFoundError as e:
            print(f"error: capture not found: {e}", file=sys.stderr)
            return 2
        tx_data = (None if args.tx_data is None
                   else _read_tx_data(args.tx_data, cfg))
        _decode_and_report(cfg, cap, tx_data, args, device)
        return 0
    if args.command == "transmit":
        return _transmit(cfg, args, device)
    return _listen(cfg, args, device)


if __name__ == "__main__":
    sys.exit(main())
