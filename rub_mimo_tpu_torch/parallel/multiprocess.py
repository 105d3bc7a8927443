"""The sharded decode across processes: one process a rank, the ranks
joined by torch.distributed (parallel.mesh.init_distributed), one mesh
over all of them.  The counterpart of the JAX package's multi-host demo
(benchmarks/multihost_demo.py: run_worker and main).

    python -m rub_mimo_tpu_torch.parallel.multiprocess --cpu
    python -m rub_mimo_tpu_torch.parallel.multiprocess --processes 4 \\
        --shards 1 --config operating_point --halo-impl pallas_dma

The first runs 2 gloo ranks of 2 CPU shards each on tiny_config's (4, 1)
mesh; the second 4 NCCL ranks, one a card.  ``--backend gloo --device
cuda:0`` puts every rank on one card.  Each rank builds the capture from
a seed with the port's simulator (the same capture on every rank),
decodes it sharded over the ranks, holds the result against the single
decode of the same capture on its own device and prints one JSON line a
case.  ``launch`` starts the ranks as subprocesses (``python -m`` of this
module, not torch.multiprocessing: a spawned child re-imports its
parent's main module), waits on each under a timeout, and raises if a
rank fails or hangs; ``main`` then exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

CONFIGS = ("tiny", "operating_point", "mimo_4x4_wideband")
G_RTOL, G_ATOL = 2e-4, 2e-5  # the sharded decode's G against the single
TIE_MARGIN = 1e-4  # decisions may differ only where the demap scores tie
# kernel -> (module of rub_mimo_tpu_torch.kernels, wrapper)
WRAPPERS = {
    "payload_fused_strip": ("payload_fused", "payload_fused_strip"),
    "payload_fused": ("payload_fused", "payload_fused"),
    "eq_demap": ("eq_demap", "eq_demap"),
    "demap": ("eq_demap", "demap"),
    "sc_sync": ("sc_sync", "sc_sync_fused"),
    "sc_metric": ("sc_metric", "sc_metric_fused"),
    "cp_strip": ("cp_strip", "cp_strip"),
    "ring_shift_right": ("halo_dma", "ring_shift_right"),
    "viterbi": ("viterbi", "viterbi"),
    "soft_llr": ("soft_llr", "soft_llr"),
    "soft_llr_rows": ("soft_llr", "soft_llr_rows"),
}
REPO = Path(__file__).resolve().parents[2]


def config_case(name: str, seed: int):
    """(ModemConfig, ChannelSpec) of a named case at a channel seed: the
    JAX demo's tiny_config at 35 dB, delay 501; the reference operating
    point at 30 dB, delay 5000; the mimo_4x4_wideband preset."""
    from rub_mimo_tpu_torch.config import ModemConfig, tiny_config
    from rub_mimo_tpu_torch.io.simulator import ChannelSpec
    from rub_mimo_tpu_torch.models import presets

    if name == "tiny":
        return (tiny_config(bit_exact=False),
                ChannelSpec(snr_db=35.0, delay=501, seed=seed))
    if name == "operating_point":
        return (ModemConfig(pid_max=1000, bit_exact=False),
                ChannelSpec(snr_db=30.0, delay=5000, seed=seed))
    if name == "mimo_4x4_wideband":
        cfg, spec = presets.mimo_4x4_wideband()
        return cfg, spec.__class__(**{**spec.__dict__, "seed": seed})
    raise ValueError(f"unknown config {name!r}; one of {CONFIGS}")


def _wrappers() -> dict:
    import importlib

    return {k: getattr(importlib.import_module(
        f"rub_mimo_tpu_torch.kernels.{mod}"), attr)
        for k, (mod, attr) in WRAPPERS.items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _top2_margin(y: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """The demap's best minus second-best score at each y."""
    from rub_mimo_tpu_torch.ofdm.constellation import demap_planes

    c = torch.as_tensor(demap_planes(table), device=y.device)
    scores = (y.real.unsqueeze(-1) * c[0] + y.imag.unsqueeze(-1) * c[1]
              - c[2])
    top = torch.topk(scores, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def compare(got, ref, cfg) -> dict:
    """A sharded decode against the single decode of the same capture:
    the sync integers equal, G within G_RTOL / G_ATOL, decisions equal
    but at near-ties of the single decode's symbols."""
    from rub_mimo_tpu_torch.ofdm import constellation

    ints = {f: int(getattr(got, f)) == int(getattr(ref, f))
            for f in ("synced", "sync_index", "sync_sample", "decode_start")}
    g_err = (got.G.to(ref.G.device) - ref.G).abs()
    g_ok = bool((g_err <= G_ATOL + G_RTOL * ref.G.abs()).all())
    bad = got.rx_data.to(ref.rx_data.device) != ref.rx_data
    n_bad = int(bad.sum())
    margins = (_top2_margin(ref.rx_sig[bad], constellation.table(
        cfg.modulation)).tolist() if n_bad else [])
    return {"ints_equal": ints, "G_max_abs_err": float(g_err.max()),
            "G_ok": g_ok, "mismatches": n_bad,
            "max_mismatch_margin": max(margins, default=0.0),
            "equal_to_single": (all(ints.values()) and g_ok
                                and all(m < TIE_MARGIN for m in margins))}


def _ser(rx_data: torch.Tensor, tx_data, cfg) -> list:
    """SER % of each rx stream s against tx stream s."""
    n = cfg.pid_max * cfg.M_occupied
    got, tx = rx_data.cpu().numpy(), np.asarray(tx_data)
    return [float((got[s, :n] != tx[s, :n]).mean() * 100.0)
            for s in range(cfg.num_streams)]


def _host_syncs() -> list:
    """What a steady-state exchange must not call, as (owner, name): host
    synchronization, the group, a copy."""
    import torch.distributed as dist

    return [(torch.cuda, "synchronize"), (torch.cuda.Stream, "synchronize"),
            (torch.cuda.Event, "synchronize"), (dist, "barrier"),
            (dist, "all_reduce"), (dist, "all_gather_object"),
            (dist, "broadcast"), (torch.Tensor, "copy_")]


class CountHostSyncs:
    """While active, count every call of ``_host_syncs()`` in this
    process (``calls``) and, where there is CUDA, fail any synchronizing
    CUDA operation (torch.cuda.set_sync_debug_mode("error"))."""

    def __enter__(self):
        self.calls, self._saved = 0, []
        for owner, name in _host_syncs():
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))

            def counted(*a, _fn=fn, **k):
                self.calls += 1
                return _fn(*a, **k)

            setattr(owner, name, counted)
        self._mode = None
        if torch.cuda.is_available():
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        return self

    def __exit__(self, *exc):
        if self._mode is not None:
            torch.cuda.set_sync_debug_mode(self._mode)
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        return False


def _column_halos(col, n_time: int, S: int, H: int, seed: int, device):
    """Seeded complex64 [S, H] halos of every time shard (the same on
    every rank), each rank's own on its device: (the rank's parts, the
    reference halos received)."""
    from rub_mimo_tpu_torch.kernels import halo_dma

    rng = np.random.default_rng(seed)
    every = [(rng.standard_normal((S, H)) + 1j * rng.standard_normal(
        (S, H))).astype(np.complex64) for _ in range(n_time)]
    parts = [[torch.as_tensor(every[t], device=device)
              if col.is_local(t, 0) else None] for t in range(n_time)]
    ref = halo_dma.ring_shift_right_reference(
        [[torch.as_tensor(x)] for x in every], col)
    return parts, ref


def _halo_check(dec, planes, cap, mesh, cfg, calls: int = 0) -> dict:
    """K8 across processes (the decoder's ProcessHalo) on this capture's
    own halos, bit for bit against ring_shift_right_reference of every
    shard's halo (each rank holds the whole capture); then ``calls``
    back-to-back calls on fresh seeded halos with no host synchronization
    between them (counted: ``host_syncs_per_call``), each received halo
    bit for bit against the plain version after one synchronize."""
    from rub_mimo_tpu_torch.kernels import halo_dma
    from rub_mimo_tpu_torch.parallel import collectives as coll
    from rub_mimo_tpu_torch.parallel import mesh as pmesh

    col = mesh.sub(cols=slice(0, 1))
    H = cfg.M - 1
    n_time = col.shape["time"]
    tails = coll.for_each(col, lambda t, s: torch.complex(
        planes[0][t][0][:, -H:], planes[1][t][0][:, -H:]))
    full = pmesh.shard_capture(cap, pmesh.Mesh(np.array(
        [[cap.device]] * n_time, dtype=object)))
    ref = halo_dma.ring_shift_right_reference(
        [[b[0][:, -H:]] for b in full], col)
    got = dec.exchange(tails)
    _sync(cap.device)
    mine = [t for t, _ in col.local_shards()]
    err, equal = 0.0, True
    for t in mine:
        equal &= torch.equal(got[t][0], ref[t][0])
        err = max(err, float((got[t][0] - ref[t][0]).abs().max()))
    remote = [t for t in mine if t > 0 and not col.is_local(t - 1, 0)]
    out = {"bit_equal": bool(equal), "max_abs_err": err,
           "halo": [cfg.num_streams, H], "shards": len(mine),
           "reads": sum(t > 0 for t in mine), "remote_reads": len(remote),
           "remote_on_another_card": any(
               col.devices[t - 1, 0] != col.devices[t, 0] for t in remote)}
    if calls:
        cases = [_column_halos(col, n_time, cfg.num_streams, H, 1000 + i,
                               cap.device) for i in range(calls)]
        launches = halo_dma.ring_shift_right.launches
        with CountHostSyncs() as counted:
            recv = [dec.exchange(parts) for parts, _ in cases]
        _sync(cap.device)
        same = all(torch.equal(r[t][0].cpu(), want[t][0])
                   for r, (_, want) in zip(recv, cases) for t in mine)
        out.update(back_to_back_calls=calls,
                   back_to_back_bit_equal=bool(same),
                   host_syncs_per_call=counted.calls / calls,
                   launches_per_call=(halo_dma.ring_shift_right.launches
                                      - launches) / calls)
    return out


def _median_split(splits: list) -> dict:
    keys = splits[0].keys()
    return {k: (None if splits[0][k] is None else
                statistics.median(s[k] for s in splits)) for k in keys}


def _profile_halo(dec, planes, cfg, n: int) -> dict:
    """The cross-process K8 of one rank, each call after a barrier that
    lines the ranks up (outside the timing): the host time of the call
    alone (``launch_ms_median``: it returns once the kernel is queued)
    and with the stream synchronized after it
    (``exchange_wall_ms_median``); ``back_to_back_ms_per_call``, n calls
    and one synchronize; the kernel's own marks (``split_us``: publish,
    the neighbour's wait and the pull, medians of n calls); and its
    device time (torch.profiler, mean µs a launch over n calls, the wait
    included)."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rub_mimo_tpu_torch.kernels import halo_dma
    from rub_mimo_tpu_torch.parallel import collectives as coll

    ex = dec.exchange
    col, dev = ex.mesh, ex.device
    H = cfg.M - 1
    tails = coll.for_each(col, lambda t, s: torch.complex(
        planes[0][t][0][:, -H:], planes[1][t][0][:, -H:]))
    out = ex(tails)
    stream = torch.cuda.current_stream(dev)

    def barrier():
        stream.synchronize()
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[dev.index])
        else:
            dist.barrier()

    launch, wall = [], []
    for times, synced in ((launch, False), (wall, True)):
        for _ in range(n):
            barrier()
            t0 = time.perf_counter()
            ex(tails, out=out)
            if synced:
                stream.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        ex(tails, out=out)
    stream.synchronize()
    b2b = (time.perf_counter() - t0) * 1e3 / n
    marks = []
    for _ in range(n):
        m = ex.marks_buffer()
        barrier()
        ex(tails, out=out, marks=m)
        marks.append(m)
    stream.synchronize()
    n_pub = len(ex.plan.publish)
    split = _median_split([halo_dma.split_us(m.cpu().numpy(), n_pub,
                                             ex.remote) for m in marks])
    barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            ex(tails, out=out)
            barrier()
    ev = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA
          and "halo_exchange_kernel" in e.name]
    return {"kernel_us": statistics.mean(ev) if ev else None,
            "kernel_launches_profiled": len(ev),
            "launch_ms_median": statistics.median(launch),
            "exchange_wall_ms_median": statistics.median(wall),
            "back_to_back_ms_per_call": b2b, "split_us": split}


def run_case(dist_info: dict, mesh_shape: Sequence[int], case: tuple, *,
             device: torch.device, shards_per_process: int, halo_impl: str,
             timing_iters: int = 0, out_dir: Optional[str] = None,
             halo_calls: int = 0) -> dict:
    """One case on this rank: the capture of ``case`` (config name, seed,
    cfg, capture, tx_data, the single decode of it on this rank's device)
    decoded sharded over the ranks from (re, im) planes, and held against
    the single decode."""
    import torch.distributed as dist

    from rub_mimo_tpu_torch.parallel import decode_sharded as ds
    from rub_mimo_tpu_torch.parallel import mesh as pmesh

    config, seed, cfg, cap, tx_data, ref = case
    mesh = pmesh.make_mesh(*mesh_shape, devices=[device] * shards_per_process)
    planes = pmesh.shard_capture_planes(cap, mesh)
    t0 = mesh.local_shards()[0][0]
    T = mesh.shape["time"] * planes[0][t0][0].shape[1]
    dec = ds.build_sharded_decoder(cfg, mesh, T, halo_impl=halo_impl,
                                   input_format="planes")
    rec = {**dist_info, "device": str(device), "config": config,
           "seed": seed, "mesh": list(mesh_shape), "halo_impl": halo_impl,
           "shards_per_process": shards_per_process,
           "local_shards": [list(x) for x in mesh.local_shards()],
           "capture": list(cap.shape)}
    try:
        if dec.exchange is not None:
            rec["k8"] = _halo_check(dec, planes, cap, mesh, cfg,
                                    halo_calls)
        wrappers = _wrappers()
        for w in wrappers.values():
            w.launches = 0
        got = dec(*planes)
        _sync(device)
        rec["launches"] = {k: w.launches for k, w in wrappers.items()}
        rec.update(synced=bool(got.synced), sync_index=int(got.sync_index),
                   sync_sample=int(got.sync_sample),
                   decode_start=int(got.decode_start),
                   cfo_hat=float(got.cfo_hat),
                   ser_percent=_ser(got.rx_data, tx_data, cfg),
                   **compare(got, ref, cfg))
        if out_dir is not None:
            name = (f"rank{dist_info['rank']}_{config}_{seed}_"
                    f"{mesh_shape[0]}x{mesh_shape[1]}_{halo_impl}.npz")
            np.savez(Path(out_dir) / name, **{
                f: getattr(got, f).cpu().numpy() for f in got._fields})
        if timing_iters:
            wall = []
            for _ in range(timing_iters):
                dist.barrier()
                t_0 = time.perf_counter()
                dec(*planes)
                _sync(device)
                wall.append((time.perf_counter() - t_0) * 1e3)
            rec["wall_ms"] = {"median": statistics.median(wall),
                              "min": min(wall), "max": max(wall),
                              "runs": timing_iters}
            if dec.exchange is not None:
                rec["k8"].update(_profile_halo(dec, planes, cfg,
                                               timing_iters))
    finally:
        dec.close()
    return rec


def run_worker(process_id: int, num_processes: int, shards_per_process: int,
               *, device: str, backend: str, init_method: str,
               halo_impl="ppermute", config: str = "tiny",
               meshes: Sequence[Sequence[int]] = ((4, 1),),
               seeds: Sequence[int] = (11,), timing_iters: int = 0,
               out_dir: Optional[str] = None, halo_calls: int = 0) -> list:
    """Rank ``process_id`` of ``num_processes``: join the group, run every
    (halo_impl, mesh, seed) case (halo_impl: one name or several), print
    one JSON line a case and return the records.  device: "cpu", "cuda"
    (this rank's card: rank modulo the cards) or "cuda:N" (card N for
    every rank)."""
    import torch.distributed as dist

    from rub_mimo_tpu_torch.io import simulator
    from rub_mimo_tpu_torch.parallel.mesh import init_distributed
    from rub_mimo_tpu_torch.pipeline import rx

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        device = f"cuda:{process_id % torch.cuda.device_count()}"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(num_processes=num_processes, process_id=process_id,
                     backend=backend, init_method=init_method)
    info = {"rank": process_id, "world": num_processes, "backend": backend}
    impls = [halo_impl] if isinstance(halo_impl, str) else list(halo_impl)
    out = []
    try:
        for seed in seeds:
            cfg, spec = config_case(config, seed)
            cap, tx_data, _ = simulator.simulate_capture(cfg, spec,
                                                         device=dev)
            case = (config, seed, cfg, cap, tx_data,
                    rx.make_decoder(cfg, device=dev)(cap))
            for impl in impls:
                for shape in meshes:
                    rec = run_case(info, shape, case, device=dev,
                                   shards_per_process=shards_per_process,
                                   halo_impl=impl, timing_iters=timing_iters,
                                   out_dir=out_dir, halo_calls=halo_calls)
                    rec["jax_loaded"] = any(
                        m == "jax" or m.startswith(("jax.", "rub_mimo_tpu."))
                        for m, v in sys.modules.items() if v is not None)
                    print(json.dumps(rec), flush=True)
                    out.append(rec)
    finally:
        dist.destroy_process_group()
    return out


def single_controller_ms(config: str, seed: int, shape: Sequence[int],
                         devices: Sequence, halo_impls: Sequence[str],
                         iters: int) -> dict:
    """The same case decoded by one controller over the same mesh (this
    process, no group): {halo_impl: wall ms a decode, median / min / max
    of iters after one warm-up, every device synchronized at both ends}."""
    from rub_mimo_tpu_torch.io import simulator
    from rub_mimo_tpu_torch.parallel import decode_sharded as ds
    from rub_mimo_tpu_torch.parallel import mesh as pmesh

    devs = [torch.device(d) for d in devices]
    cfg, spec = config_case(config, seed)
    cap = simulator.simulate_capture(cfg, spec, device=devs[0])[0]
    mesh = pmesh.make_mesh(*shape, devices=devs)
    planes = pmesh.shard_capture_planes(cap, mesh)
    T = mesh.shape["time"] * planes[0][0][0].shape[1]

    def sync():
        for d in set(devs):
            _sync(d)

    out = {}
    for impl in halo_impls:
        dec = ds.build_sharded_decoder(cfg, mesh, T, halo_impl=impl,
                                       input_format="planes")
        dec(*planes)
        sync()
        wall = []
        for _ in range(iters):
            t0 = time.perf_counter()
            dec(*planes)
            sync()
            wall.append((time.perf_counter() - t0) * 1e3)
        out[impl] = {"median": statistics.median(wall), "min": min(wall),
                     "max": max(wall), "runs": iters}
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(num_processes: int = 2, shards_per_process: int = 2, *,
           device: str = "cuda", backend: Optional[str] = None,
           init_method: Optional[str] = None, halo_impl="ppermute",
           config: str = "tiny", meshes: Sequence[Sequence[int]] = ((4, 1),),
           seeds: Sequence[int] = (11,), timing_iters: int = 0,
           out_dir: Optional[str] = None, timeout: float = 120.0,
           halo_calls: int = 0) -> list:
    """Run ``num_processes`` ranks of run_worker as subprocesses, each
    waited on until ``timeout`` seconds after the start; returns every
    rank's records (rank-major).  The ranks run on CUDA unless ``device``
    is "cpu"; ``backend`` defaults to "nccl" on CUDA and "gloo" on the
    CPU.  Raises RuntimeError for a CUDA device without CUDA, and, with
    the ranks' output, if any rank exits non-zero or is still running at
    the timeout (all ranks are then killed)."""
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError('multiprocess.launch: no CUDA device; pass '
                           'device="cpu" for CPU ranks under gloo')
    if backend is None:
        backend = "gloo" if device == "cpu" else "nccl"
    if init_method is None:
        init_method = f"tcp://127.0.0.1:{free_port()}"
    argv = ["--processes", str(num_processes), "--shards",
            str(shards_per_process), "--device", device, "--backend",
            backend, "--init-method", init_method, "--config", config,
            "--timing-iters", str(timing_iters), "--halo-calls",
            str(halo_calls)]
    for impl in [halo_impl] if isinstance(halo_impl, str) else halo_impl:
        argv += ["--halo-impl", impl]
    for shape in meshes:
        argv += ["--mesh", f"{shape[0]},{shape[1]}"]
    for seed in seeds:
        argv += ["--seed", str(seed)]
    if out_dir is not None:
        argv += ["--out-dir", str(out_dir)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = []
    for rank in range(num_processes):
        out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "rub_mimo_tpu_torch.parallel.multiprocess",
             "--worker", str(rank), *argv], cwd=REPO, env=env, stdout=out,
            stderr=err), out, err))
    deadline = time.monotonic() + timeout
    failed = []
    for rank, (p, _, _) in enumerate(procs):
        try:
            rc = p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            failed.append(f"rank {rank} still running after {timeout} s")
            for q, _, _ in procs:
                q.kill()
            for q, _, _ in procs:
                q.wait()
            break
        if rc != 0:
            failed.append(f"rank {rank} exited {rc}")
    records, logs = [], []
    for rank, (p, out, err) in enumerate(procs):
        out.seek(0)
        err.seek(0)
        text = out.read().decode(errors="replace")
        records += [json.loads(ln) for ln in text.splitlines()
                    if ln.startswith("{")]
        logs.append(f"--- rank {rank} stdout\n{text[-4000:]}\n--- rank "
                    f"{rank} stderr\n"
                    f"{err.read().decode(errors='replace')[-4000:]}")
        out.close()
        err.close()
    if failed:
        raise RuntimeError("; ".join(failed) + "\n" + "\n".join(logs))
    return records


def _shape(s: str) -> tuple:
    a, b = s.split(",")
    return int(a), int(b)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the sharded decode across processes, one rank a "
                    "process, each held against the single decode")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--shards", type=int, default=None,
                    help="shards a process (default 2 with --cpu, else 1)")
    ap.add_argument("--cpu", action="store_true",
                    help="CPU ranks under gloo")
    ap.add_argument("--device", default=None,
                    help="cpu, cuda (each rank its card) or cuda:N")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default gloo with --cpu, else nccl")
    ap.add_argument("--init-method", default=None,
                    help="rendezvous URL (default tcp://127.0.0.1:<free>)")
    ap.add_argument("--halo-impl", choices=("ppermute", "pallas_dma"),
                    action="append", default=None,
                    help="repeatable (default ppermute)")
    ap.add_argument("--config", choices=CONFIGS, default="tiny")
    ap.add_argument("--mesh", type=_shape, action="append", default=None,
                    help="n_time,n_sc (repeatable; default all ranks' "
                         "shards along time)")
    ap.add_argument("--seed", type=int, action="append", default=None)
    ap.add_argument("--timing-iters", type=int, default=0)
    ap.add_argument("--halo-calls", type=int, default=0,
                    help="back-to-back K8 exchanges held against the plain "
                         "version a pallas_dma case, no host sync between")
    ap.add_argument("--out-dir", default=None,
                    help="write each rank's result of each case as .npz")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--versus-single", action="store_true",
                    help="first time the single-controller decode of each "
                         "mesh over the same devices (--timing-iters runs)")
    ap.add_argument("--worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    device = a.device or ("cpu" if a.cpu else "cuda")
    if device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device: pass --cpu for CPU ranks", file=sys.stderr)
        return 2
    backend = a.backend or ("gloo" if device == "cpu" else "nccl")
    shards = a.shards or (2 if device == "cpu" else 1)
    meshes = a.mesh or [(a.processes * shards, 1)]
    seeds = a.seed or [11]
    impls = a.halo_impl or ["ppermute"]
    if a.worker is not None:
        if device == "cpu":
            torch.set_num_threads(1)
        recs = run_worker(a.worker, a.processes, shards, device=device,
                          backend=backend, init_method=a.init_method,
                          halo_impl=impls, config=a.config,
                          meshes=meshes, seeds=seeds,
                          timing_iters=a.timing_iters, out_dir=a.out_dir,
                          halo_calls=a.halo_calls)
        k8_ok = all(r["k8"].get(k, True) for r in recs if "k8" in r
                    for k in ("bit_equal", "back_to_back_bit_equal"))
        return 0 if k8_ok and all(r["equal_to_single"] for r in recs) else 1
    if a.versus_single:
        if device == "cuda":  # each rank's card, as run_worker picks it
            n = torch.cuda.device_count()
            devs = [f"cuda:{r % n}" for r in range(a.processes)
                    for _ in range(shards)]
        else:
            devs = [device] * (a.processes * shards)
        for shape in meshes:
            for seed in seeds:
                print(json.dumps({
                    "single_controller": True, "config": a.config,
                    "seed": seed, "mesh": list(shape), "devices": devs,
                    "wall_ms": single_controller_ms(
                        a.config, seed, shape, devs, impls,
                        max(a.timing_iters, 1))}), flush=True)
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
    try:
        recs = launch(a.processes, shards, device=device, backend=backend,
                      init_method=a.init_method, halo_impl=impls,
                      config=a.config, meshes=meshes, seeds=seeds,
                      timing_iters=a.timing_iters, out_dir=a.out_dir,
                      timeout=a.timeout, halo_calls=a.halo_calls)
    except RuntimeError as e:
        print(f"multiprocess decode failed: {e}", file=sys.stderr)
        return 1
    for r in recs:
        print(json.dumps(r))
    print("multiprocess decode: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
