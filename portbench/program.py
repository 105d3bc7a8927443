"""The system under test: the served decode of rub_mimo_tpu_torch.

The only module of the benchmark that imports the program.  A config's
``modem`` object becomes the program's ModemConfig, its ``port`` object
the serving decoder's options, and its ``fec`` object (when not null)
the coded back end after each decode.  One call serves one capture:
``rx.make_serving_decoder`` (one CUDA graph replay a capture: the input
copy, the decode, the output copies), then, in a coded configuration,
``fec.decode_payload`` on the kept equalized symbols.  Nothing is read
back to the host.  ``run.stages`` names the path's stages; the harness
sets ``run.mark``, called between two stages, to record where the next
one's launches begin.
"""

from __future__ import annotations

import importlib


def modem_config(modem: dict):
    """The program's ModemConfig of a config's ``modem`` object."""
    from rub_mimo_tpu_torch import config as c

    kw = dict(modem)
    kw["modulation"] = c.Modulation(kw["modulation"])
    kw["detector"] = c.Detector(kw.get("detector", "zf"))
    kw["mode"] = c.CommMode(kw.get("mode", "rx_zf"))
    if "lfsr_large_polys" in kw:  # a JSON list; the config is hashed
        kw["lfsr_large_polys"] = tuple(kw["lfsr_large_polys"])
    return c.ModemConfig(**kw).validate()


def make(config: dict, device):
    """run(re, im) for planes [1, S, T]: the served decode's stacked
    DecodeResult and, coded, the message bits; ``run.answer`` turns that
    into the dict the check reads (synced, sync_index, decode_start, G
    [M, rx, tx], rx_sig, rx_data, msg), done only for the answers kept."""
    from rub_mimo_tpu_torch.ofdm import fec
    from rub_mimo_tpu_torch.pipeline import rx

    cfg = modem_config(config["modem"])
    port = config["port"]
    serve = rx.make_serving_decoder(
        cfg, device=device, input_format="planes",
        sync_impl=port["sync_impl"], payload_impl=port["payload_impl"],
        keep_rx_sig=port["keep_rx_sig"])
    coded = config.get("fec")

    def run(re, im):
        r = serve(re, im)
        if coded:
            run.mark()
            return r, fec.decode_payload(r.rx_sig[0], cfg, rate=coded["rate"])
        return r, None

    def answer(out) -> dict:
        r, msg = out
        a = {"synced": r.synced[0], "sync_index": r.sync_index[0],
             "decode_start": r.decode_start[0], "G": r.G[0],
             "rx_sig": r.rx_sig[0], "rx_data": r.rx_data[0]}
        if msg is not None:
            a["msg"] = msg
        return a

    run.answer = answer
    run.stages = ("decode", "fec") if coded else ("decode",)
    run.mark = lambda: None
    return run


def counters(names: dict) -> dict:
    """The launch counts of the program's kernel wrappers named as
    ``module:attribute`` (values of ``names``), by key."""
    out = {}
    for key, where in names.items():
        mod, attr = where.split(":")
        out[key] = getattr(importlib.import_module(mod), attr).launches
    return out
