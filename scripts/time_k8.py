#!/usr/bin/env python3
"""K8 across processes on NVIDIA GPUs: the halo exchange alone, the
time split inside it, what slows its pull through an IPC mapping, and
rank 0's sharded decode beside it.

    python3 scripts/time_k8.py [--root DIR] [--iters 20] [--calls 200]
                               [--cases one_card_gloo,cards_nccl]
                               [--variants] [--ablate] [--decode-iters 10]

For the package at ``--root`` (default this checkout; an unpacked parent
commit times the parent in the same call on the same cards) and each
case, it starts the ranks as processes of this script (``--worker``),
each building ``kernels.halo_dma.ProcessHalo`` of that package on the
reference operating point's halos ([2, 2047] complex64, the (n, 1) mesh's
"time" column: ``one_card_gloo`` 2 gloo ranks of 2 shards on cuda:0,
``cards_nccl`` one NCCL rank a card, skipped on one card).  Each rank
reports, medians of ``--iters`` calls each made after a barrier that
lines the ranks up (outside the timing): the host time of the call
alone (``launch_ms``) and with its stream synchronized after it
(``synced_ms``); ``--calls`` back-to-back calls and one synchronize
(``back_to_back_ms_per_call``, every received halo held bit for bit
against ``ring_shift_right_reference``); the kernel's device time
(torch.profiler, mean µs a launch: the wait included where the kernel
waits); and, where the package's exchange takes ``marks=``, the kernel's
own split (``halo_dma.split_us``: publish, the neighbour's wait, the
pull).  ``--decode-iters`` then runs that package's
``parallel.multiprocess.launch`` on the same ranks (the operating point,
(n, 1), ``pallas_dma``) and reports rank 0's wall ms a decode.

``--variants`` (this checkout only) times the same exchange with its
waits placed elsewhere (``variant``): in the kernel alone (its acquire
spins, no stream wait) and as a publish launch, the stream's wait and a
pull launch; the exchange itself queues the stream's waits before its
one launch.

``--ablate`` (this checkout only) builds a probe kernel into
rub_mimo_tpu_torch/_build/ and times, on a reader rank, a pull of one
halo through each route: the neighbour rank's IPC-mapped buffer, a
buffer this process holds on the neighbour's card by peer access (cards
only: the single controller's route) and this card's own memory.  Each
launch reads the halo, then the other slot of the same allocation (the
same pages, other bytes), then the first halo again, with globaltimer
and clock64 marks between, at several block grids, in the steady state
and after a 256 MB write on the reader's card: first-touch translation
misses, the route and the grid, told apart.
Prints the card line, then one JSON line.  Exits non-zero without a CUDA
device, or where a rank fails or a halo differs."""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
S, H = 2, 2047      # the operating point's halo: [S, M - 1]
BLOCK = 4096        # the row length of the blocks the halos end
SWEEP_BYTES = 256 << 20         # written on the reader's card: TLB and L2
# (blocks, threads) of the probe: the exchange's own 16 x 256, then the
# same threads as fewer, wider blocks and as more, narrower ones
GRIDS = ((16, 256), (4, 1024), (1, 1024), (64, 64))

PROBE = r'''
#include <cuda_runtime.h>
__device__ __forceinline__ long long gtime() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void mark(long long* m, int at) {
  __syncthreads();
  if (threadIdx.x == 0) { m[at] = gtime(); m[4 + at] = clock64(); }
}
// reads `a` (n float2), then `b`, then `a` again, into dst
__global__ void probe(const float2* __restrict__ a,
                      const float2* __restrict__ b,
                      float2* __restrict__ dst, int n, long long* marks) {
  long long* m = marks + 8 * blockIdx.x;
  const int step = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  mark(m, 0);
  for (int e = first; e < n; e += step) dst[e] = __ldcg(a + e);
  mark(m, 1);
  for (int e = first; e < n; e += step) dst[n + e] = __ldcg(b + e);
  mark(m, 2);
  for (int e = first; e < n; e += step) dst[e] = __ldcg(a + e);
  mark(m, 3);
}
extern "C" int launch_probe(const void* a, const void* b, void* dst, int n,
                            void* marks, int blocks, int threads,
                            void* stream) {
  probe<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float2*)a, (const float2*)b, (float2*)dst, n,
      (long long*)marks);
  return (int)cudaGetLastError();
}
'''


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def med(xs) -> float:
    return statistics.median(xs)


# ----------------------------------------------------------------- a rank
def halo_case(col, seed: int, dev):
    """Seeded halos of every time shard (the same on every rank), this
    rank's as the last H samples of [S, BLOCK] blocks on its card: (the
    rank's tails, strided views as stage A's, and the reference halos
    received, numpy)."""
    rng = np.random.default_rng(seed)
    n_time = col.shape["time"]
    tails, every = [], []
    for t in range(n_time):
        x = (rng.standard_normal((S, H)) + 1j * rng.standard_normal(
            (S, H))).astype(np.complex64)
        every.append(x)
        if col.is_local(t, 0):
            blk = torch.zeros((S, BLOCK), dtype=torch.complex64, device=dev)
            blk[:, -H:] = torch.as_tensor(x, device=dev)
            tails.append([blk[:, -H:]])
        else:
            tails.append([None])
    want = [np.zeros((S, H), np.complex64) if t == 0 else every[t - 1]
            for t in range(n_time)]
    return tails, want


def exchange_rank(ex, col, dev, iters: int, calls: int, fn=None) -> dict:
    """One rank's timings of ``ex`` (either package's ProcessHalo), or of
    ``fn`` (a ``variant`` of this checkout's)."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rub_mimo_tpu_torch.kernels import halo_dma

    mine = [t for t, _ in col.local_shards()]
    fn = ex if fn is None else fn
    takes_out = "out" in inspect.signature(fn).parameters
    stream = torch.cuda.current_stream(dev)
    n_time = col.shape["time"]

    def rows_out(rows):
        return [[rows[mine.index(t), :, :H] if t in mine else None]
                for t in range(n_time)]

    # each back-to-back call writes rows of its own (stage A's layout)
    rows = torch.zeros((calls + 1, len(mine), S, H + 64),
                       dtype=torch.complex64, device=dev)
    outs = [rows_out(r) for r in rows]

    def call(tails, i=calls):
        return fn(tails, out=outs[i]) if takes_out else fn(tails)

    def barrier():
        stream.synchronize()
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[dev.index])
        else:
            dist.barrier()

    tails, _ = halo_case(col, 5, dev)
    call(tails)
    launch, synced = [], []
    for times, sync in ((launch, False), (synced, True)):
        for _ in range(iters):
            barrier()
            t0 = time.perf_counter()
            call(tails)
            if sync:
                stream.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    cases = [halo_case(col, 100 + i, dev) for i in range(calls)]
    barrier()
    t0 = time.perf_counter()
    got = [call(tl, i) for i, (tl, _) in enumerate(cases)]
    stream.synchronize()
    b2b = (time.perf_counter() - t0) * 1e3 / calls
    equal = all(np.array_equal(g[t][0].cpu().numpy(), want[t])
                for g, (_, want) in zip(got, cases) for t in mine)
    res = {"launch_ms": med(launch), "synced_ms": med(synced),
           "launch_ms_all": launch, "synced_ms_all": synced,
           "back_to_back_ms_per_call": b2b, "back_to_back_calls": calls,
           "back_to_back_bit_equal": bool(equal)}
    barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call(tails)
            barrier()
    names = ("halo_exchange_kernel", "ring_shift_right_kernel")
    ev = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA
          and any(n in e.name for n in names)]
    res["kernel_us"] = statistics.mean(ev) if ev else None
    res["kernel_launches_profiled"] = len(ev)
    split = hasattr(ex, "marks_buffer") and (
        fn is ex or getattr(fn, "marks", False))
    if split:
        splits = []
        for _ in range(iters):
            m = ex.marks_buffer()
            barrier()
            fn(tails, out=outs[calls], marks=m)
            stream.synchronize()
            splits.append(halo_dma.split_us(m.cpu().numpy(),
                                            len(ex.plan.publish),
                                            ex.remote))
        res["split_us"] = {k: (None if splits[0][k] is None else
                               med([s[k] for s in splits]))
                           for k in splits[0]}
        res["split_us_all"] = splits
    return res


def build_probe() -> Path:
    """Compile PROBE into rub_mimo_tpu_torch/_build/ (this checkout's
    nvcc flags)."""
    from rub_mimo_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "k8_probe.cu"
    so = _build.BUILD_DIR / "k8_probe.so"
    cu.write_text(PROBE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    return so


def probe_lib():
    lib = ctypes.CDLL(str(REPO / "rub_mimo_tpu_torch" / "_build" /
                          "k8_probe.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.launch_probe.argtypes = [P, P, P, I, P, I, I, P]
    lib.launch_probe.restype = I
    return lib


def variant(ex, mode: str):
    """This checkout's exchange with its waits placed elsewhere:
    "kernel_wait", no stream waits (the kernel's acquire spins until its
    word is raised); "publish_wait_pull", the stream's waits for the
    consumed words, a publish-only launch, its waits for the arrived
    words, then a pull-only launch.  Returns call(parts, out=None,
    marks=None) -> out."""
    from rub_mimo_tpu_torch.kernels import halo_dma

    k8 = halo_dma._lib()

    def wait(h, kind, e):
        for index, k in ex._wait_words:
            want = e if k == "arrived" else halo_dma.reuse_epoch(e)
            if k == kind and want:
                err = k8.stream_wait_geq(
                    h, ex.page.dev + index * halo_dma.WORD_BYTES, want)
                if err != 0:
                    raise SystemExit(f"time_k8.py: the stream wait failed: "
                                     f"{err}")

    def launch(p, h):
        err = k8.halo_exchange(ctypes.byref(p), h)
        if err != 0:
            raise SystemExit(f"time_k8.py: launch failed: {err}")

    def call(parts, out=None, marks=None):
        p, out = ex.params(parts, out, marks)
        h = torch.cuda.current_stream(ex.device).cuda_stream
        if mode == "kernel_wait":
            launch(p, h)
        else:
            wait(h, "consumed", p.epoch)
            if p.n_pub:
                pub = type(p).from_buffer_copy(p)
                pub.n_dst, pub.marks = 0, None
                launch(pub, h)
            wait(h, "arrived", p.epoch)
            pull = type(p).from_buffer_copy(p)
            pull.n_pub, pull.marks = 0, None
            launch(pull, h)
        ex.epoch = p.epoch
        return out

    call.marks = mode == "kernel_wait"
    return call


def probe_rank(dev, rank: int, world: int, iters: int) -> dict:
    """The IPC pull ablation between ranks 0 and 1 (rank 0 exports two
    halos of one allocation, rank 1 pulls); {} on the other ranks."""
    import torch.distributed as dist

    from rub_mimo_tpu_torch.kernels import _build
    from rub_mimo_tpu_torch.kernels import halo_dma

    lib = probe_lib()
    n = S * H
    halo = n * 8
    info = [None]
    vals = torch.randn((2, S, H), dtype=torch.complex64,
                       generator=torch.Generator().manual_seed(3))
    if rank == 0:
        src = vals.to(dev)
        torch.cuda.synchronize(dev)
        h, off = ctypes.create_string_buffer(64), ctypes.c_longlong()
        assert halo_dma._lib().ipc_export(dev.index, src.data_ptr(), h,
                                          ctypes.byref(off)) == 0
        info = [(h.raw, off.value, dev.index)]
    dist.broadcast_object_list(info, src=0)
    out = {}
    if rank == 1:
        handle, off, src_card = info[0]
        base = ctypes.c_void_p()
        assert halo_dma._lib().ipc_open(dev.index, handle,
                                        ctypes.byref(base)) == 0
        routes = {"ipc_mapped": base.value + off}
        if src_card != dev.index:
            peer = torch.randn((2, S, H), dtype=torch.complex64,
                               device=torch.device("cuda", src_card))
            halo_dma._enable_peer(dev, peer.device)
            routes["peer_same_process"] = peer.data_ptr()
        own = torch.randn((2, S, H), dtype=torch.complex64, device=dev)
        routes["own_card"] = own.data_ptr()
        dst = torch.empty((2, S, H), dtype=torch.complex64, device=dev)
        sweep = torch.empty(SWEEP_BYTES, dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev)
        torch.cuda.synchronize(dev)
        for route, a in routes.items():
            for blocks, threads in GRIDS:
                for state in ("steady", "after_sweep"):
                    marks = torch.zeros((iters, blocks, 8),
                                        dtype=torch.int64, device=dev)
                    for i in range(iters + 2):
                        if state == "after_sweep":
                            sweep.fill_(i & 0xFF)
                        m = marks[max(i - 2, 0)]  # two warm-up launches
                        err = lib.launch_probe(a, a + halo, dst.data_ptr(),
                                               n, m.data_ptr(), blocks,
                                               threads, stream.cuda_stream)
                        assert err == 0, err
                    torch.cuda.synchronize(dev)
                    mk = marks.cpu().numpy()
                    # per launch: each pass from the first block's start
                    # to the last block's end, and its longest block in
                    # cycles
                    passes = {}
                    for j, name in enumerate(("first_read", "other_slot",
                                              "read_again")):
                        span = (mk[:, :, j + 1].max(1)
                                - mk[:, :, j].min(1)) / 1e3
                        cyc = (mk[:, :, 5 + j] - mk[:, :, 4 + j]).max(1)
                        passes[name] = {"us": float(np.median(span)),
                                        "cycles": int(np.median(cyc))}
                    out.setdefault(route, {}).setdefault(
                        f"{blocks}x{threads}", {})[state] = passes
                    if route == "ipc_mapped" and not torch.equal(
                            dst.cpu(), vals):
                        raise SystemExit("time_k8.py: the probe read other "
                                         "values through the IPC mapping")
        assert halo_dma._lib().ipc_close(dev.index, base.value) == 0
    dist.barrier()
    return out


def worker(a) -> None:
    sys.path.insert(0, str(Path(a.root).resolve()))
    import torch.distributed as dist

    from rub_mimo_tpu_torch.kernels import halo_dma
    from rub_mimo_tpu_torch.parallel import mesh as pmesh

    rank, world = a.worker, a.world
    dev = torch.device("cuda", 0 if a.backend == "gloo" else rank)
    torch.cuda.set_device(dev)
    dist.init_process_group(a.backend, init_method=a.init_method,
                            rank=rank, world_size=world)
    per = a.per
    col = pmesh.make_mesh(world * per, 1, devices=[dev] * per)
    ex = halo_dma.ProcessHalo(col, S, H)
    rec = {"rank": rank, "device": str(dev),
           "shards": [t for t, _ in col.local_shards()],
           **exchange_rank(ex, col, dev, a.iters, a.calls)}
    if a.variants:
        rec["variants"] = {}
        for mode in ("kernel_wait", "publish_wait_pull"):
            rec["variants"][mode] = exchange_rank(
                ex, col, dev, a.iters, a.calls, variant(ex, mode))
    ex.close()
    if a.ablate:
        rec["probe"] = probe_rank(dev, rank, world, a.iters)
    dist.destroy_process_group()
    print(json.dumps(rec), flush=True)


def run_ranks(a, backend: str, world: int, per: int) -> list:
    argv = ["--root", a.root, "--iters", str(a.iters), "--calls",
            str(a.calls), "--backend", backend, "--world", str(world),
            "--per", str(per), "--init-method",
            f"tcp://127.0.0.1:{free_port()}"]
    if a.ablate:
        argv.append("--ablate")
    if a.variants:
        argv.append("--variants")
    env = dict(os.environ, PYTHONPATH=str(Path(a.root).resolve()))
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r),
                               *argv], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    recs = []
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise SystemExit(f"time_k8.py: rank {r} exited {p.returncode}:"
                             f"\n{e[-4000:]}")
        recs += [json.loads(ln) for ln in o.splitlines()
                 if ln.startswith("{")]
    bad = [r["rank"] for r in recs if not r["back_to_back_bit_equal"]]
    if bad:
        raise SystemExit(f"time_k8.py: ranks {bad} received other halos "
                         "than the plain version")
    return recs


def decode_wall(a, device: str, backend: str, world: int, per: int) -> dict:
    """Rank 0's wall ms a decode of the operating point over (n, 1) with
    pallas_dma, by the package's own parallel.multiprocess."""
    from rub_mimo_tpu_torch.parallel import multiprocess as mp

    recs = mp.launch(world, per, device=device, backend=backend,
                     halo_impl="pallas_dma", config="operating_point",
                     meshes=((world * per, 1),), seeds=(42,),
                     timing_iters=a.decode_iters, timeout=600.0)
    r0 = min(recs, key=lambda r: r["rank"])
    if not all(r["equal_to_single"] for r in recs):
        raise SystemExit("time_k8.py: a sharded decode differs from the "
                         "single decode")
    return {"wall_ms": r0["wall_ms"], "ser_percent": r0["ser_percent"],
            "launches": r0["launches"]["ring_shift_right"]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--cases", default="one_card_gloo,cards_nccl")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--decode-iters", type=int, default=10)
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=2, help=argparse.SUPPRESS)
    ap.add_argument("--per", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--backend", default="gloo", help=argparse.SUPPRESS)
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_k8.py: no CUDA device")
    if a.worker is not None:
        worker(a)
        return
    root = Path(a.root).resolve()
    if (a.ablate or a.variants) and root != REPO:
        raise SystemExit("time_k8.py: --ablate and --variants time this "
                         "checkout only")
    sys.path.insert(0, str(root))
    if a.ablate:
        build_probe()
    card = card_line()
    print(card, flush=True)
    cards = torch.cuda.device_count()
    out = {"card": card, "cards": cards, "root": str(root),
           "iters": a.iters, "calls": a.calls, "halo": [S, H]}
    for case in a.cases.split(","):
        if case == "one_card_gloo":
            spec = ("cuda:0", "gloo", 2, 2)
        elif case == "cards_nccl":
            if cards < 2:
                out[case] = {"run": False, "cards": cards}
                continue
            spec = ("cuda", "nccl", cards, 1)
        else:
            raise SystemExit(f"time_k8.py: unknown case {case!r}")
        device, backend, world, per = spec
        res = {"ranks": world, "shards_per_rank": per, "backend": backend,
               "by_rank": run_ranks(a, backend, world, per)}
        if a.decode_iters:
            res["decode"] = decode_wall(a, device, backend, world, per)
        out[case] = res
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
