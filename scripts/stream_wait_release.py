#!/usr/bin/env python3
"""What can release a stream held in the card's front end by a wait on a
flag word, from the same process, on one NVIDIA GPU.

    python3 scripts/stream_wait_release.py [--peer]

K8 across processes (kernels/halo_dma.py ProcessHalo) queues
``stream_wait_geq`` (cuStreamWaitValue64) on its own flag words before
its launch; a peer that never raises a word would hold the stream
forever, so a watchdog must be able to raise it from the waiting process.
Each method runs in a process of its own (a stream that stays held is
ended with its process): the current stream waits for word >= 1 and then
runs a kernel, and 0.2 s later the word is raised by

  kernel        a fill kernel on another (non-blocking) stream
  copy          a copy from pinned host memory on another stream
  write_value   cuStreamWriteValue64 on another stream
  host_word     a CPU store, the word in pinned host memory

from the main thread, or (``thread_*``) from a second thread while the
main thread blocks in torch.cuda.synchronize(); each writes 1.  Then two
copy 2^62 and 2^62 + 2^31 - 1 (K8's watchdog's ABORT): whether the
front end's GEQ compares all 64 bits or the low 32; and the last three
queue K8's exchange kernel (2.6 KB of parameters) or the one-controller
kernel (1 KB) behind the wait, before the fill.  ``*_exported`` waits on a
word of an allocation exported with cudaIpcGetMemHandle, as K8's flag
words are.  ``--peer`` runs every
method again with another process holding a context on the same card
(two ranks sharing a card).  Prints the card line,
then one JSON line: for each method whether the held stream finished
within 3 s of the release, and in how many seconds.  Exits non-zero
without a CUDA device."""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
METHODS = ("kernel", "copy", "write_value", "host_word", "thread_kernel",
           "thread_copy", "thread_write_value", "thread_host_word",
           "copy_2^62", "copy_2^62+2^31-1", "copy_behind_exchange",
           "copy_behind_ring_shift", "host_word_behind_exchange",
           "copy_exported", "kernel_exported", "write_value_exported")


def one(method: str) -> dict:
    sys.path.insert(0, str(REPO))
    from rub_mimo_tpu_torch.kernels import halo_dma

    lib = halo_dma._lib()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    method, _, behind = method.partition("_behind_")
    exported = method.endswith("_exported")
    method = method.removesuffix("_exported")
    kind, _, value = method.removeprefix("thread_").partition("_")
    value = {"": 1, "2^62": 1 << 62,
             "2^62+2^31-1": (1 << 62) + (1 << 31) - 1}.get(value, 1)
    kind = "host_word" if kind == "host" else kind
    kind = "write_value" if kind == "write" else kind
    host = kind == "host_word"
    word = torch.zeros(1, dtype=torch.int64, device="cpu" if host else dev,
                       pin_memory=host)
    if exported:  # as K8's flag words: in an IPC-exported allocation
        handle, offset = ctypes.create_string_buffer(64), ctypes.c_longlong()
        assert lib.ipc_export(0, word.data_ptr(), handle,
                              ctypes.byref(offset)) == 0
    one_host = torch.full((1,), value, dtype=torch.int64, pin_memory=True)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    main = torch.cuda.current_stream(dev)
    sink = torch.empty(2 * 2047, dtype=torch.complex64, device=dev)
    if behind == "exchange":  # K8's exchange kernel, 2.6 KB of params
        p = halo_dma._ExchangeParams()
        p.dst[0], p.flags, p.epoch, p.timeout_ns = (sink.data_ptr(),
                                                   sink.data_ptr(), 1, 10**9)
        p.rows, p.len, p.n_dst = 2, 2047, 1
        p.src_row_stride = p.dst_row_stride = 2047
        launch = lib.halo_exchange
    elif behind == "ring_shift":  # the one-controller kernel, 1 KB
        p = halo_dma._Params()
        p.dst[0], p.rows, p.len, p.n_dst = sink.data_ptr(), 2, 2047, 1
        p.src_row_stride = 2047
        launch = lib.ring_shift_right
    if behind:  # once before the wait: loaded, not lazily behind it
        assert launch(ctypes.byref(p), main.cuda_stream) == 0
    torch.cuda.synchronize()
    err = lib.stream_wait_geq(main.cuda_stream, word.data_ptr(), 1)
    if err != 0:
        return {"method": method, "wait_error": err}
    if behind:
        assert launch(ctypes.byref(p), main.cuda_stream) == 0
    flag.fill_(1)  # a kernel behind the wait
    done = torch.cuda.Event()
    done.record(main)

    def release():
        time.sleep(0.2)
        if kind == "kernel":
            with torch.cuda.stream(side):
                word.fill_(1)
        elif kind == "copy":
            with torch.cuda.stream(side):
                word.copy_(one_host, non_blocking=True)
        elif kind == "write_value":
            cu = ctypes.CDLL("libcuda.so.1")
            fn = cu.cuStreamWriteValue64_v2
            fn.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong,
                           ctypes.c_ulonglong, ctypes.c_uint]
            assert fn(side.cuda_stream, word.data_ptr(), 1, 0) == 0
        else:
            word.numpy()[0] = 1

    t0 = time.perf_counter()
    if method.startswith("thread_"):
        th = threading.Thread(target=release, daemon=True)
        th.start()
        torch.cuda.synchronize()  # returns once the held stream ran
        th.join()
    else:
        release()
    t_rel = time.perf_counter()
    while not done.query() and time.perf_counter() - t_rel < 3.0:
        time.sleep(0.001)
    ok = done.query()
    return {"method": method, "behind": behind, "exported": exported,
            "released": bool(ok),
            "seconds_after_release": time.perf_counter() - t_rel,
            "seconds": time.perf_counter() - t0,
            "flag": int(flag.item()) if ok else None}


def idle_peer() -> None:
    """Hold a context on cuda:0 and do nothing until killed."""
    torch.zeros(1, device="cuda:0")
    torch.cuda.synchronize()
    print("ready", flush=True)
    time.sleep(600)


def run_all(peer: bool) -> dict:
    res = {}
    for m in METHODS:
        holder = None
        if peer:
            holder = subprocess.Popen([sys.executable, __file__, "--idle"],
                                      stdout=subprocess.PIPE, text=True)
            holder.stdout.readline()  # its context exists
        try:
            p = subprocess.run([sys.executable, __file__, m],
                               capture_output=True, text=True, timeout=20)
            lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
            res[m] = json.loads(lines[-1]) if lines else {
                "method": m, "error": p.stderr[-800:]}
        except subprocess.TimeoutExpired:
            res[m] = {"method": m, "released": False, "hung": True}
        finally:
            if holder is not None:
                holder.kill()
                holder.wait()
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("stream_wait_release.py: no CUDA device")
    if sys.argv[1:] == ["--idle"]:
        idle_peer()
        return
    if len(sys.argv) > 1 and sys.argv[1] != "--peer":
        print(json.dumps(one(sys.argv[1])), flush=True)
        os._exit(0)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(out, flush=True)
    res = {"methods": run_all(False)}
    if "--peer" in sys.argv:
        res["methods_beside_a_peer_context"] = run_all(True)
    print(json.dumps({"card": out, **res}), flush=True)


if __name__ == "__main__":
    main()
