"""The ("time", "sc") device mesh of the sharded decode (port of
rub_mimo_tpu/parallel/mesh.py).

  "time" — time blocks of the capture: the S&C sync and the payload
           symbols are data-parallel in time, with overlap-save halos at
           the shard boundaries.
  "sc"   — the second axis: the matched filter's templates, the LS code
           FFTs and the payload symbols are striped over it.

One controller process drives every shard (the JAX package's design
under shard_map).  A mesh is a grid of torch devices, and a device may
repeat: ``make_mesh(4, 1, devices=["cuda:0"] * 4)`` gives four logical
shards of one card, as the JAX package's tests put eight on one CPU.  A
sharded capture is a nested list ``blocks[t][s]`` of [S, Tloc] tensors,
each on its shard's device (the blocks of one time row are the same
tensor where their devices agree).  Multi-host initialization
(``init_distributed``) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

AXES = ("time", "sc")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """devices: numpy object array [n_time, n_sc] of torch.device."""

    devices: np.ndarray
    axis_names: tuple = AXES

    @property
    def shape(self) -> dict:
        n_time, n_sc = self.devices.shape
        return {"time": n_time, "sc": n_sc}

    @property
    def home(self) -> torch.device:
        """Where the decode's replicated results are returned: shard
        (0, 0)'s device."""
        return self.devices[0, 0]


def make_mesh(num_time: Optional[int] = None, num_sc: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ("time", "sc") mesh over ``devices`` (default: every CUDA
    device, raising where there is none), laid out time-major; the first
    num_time * num_sc devices are used."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices "
                               "(e.g. ['cpu'] * n) for a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if num_time is None:
        num_time = len(devices) // num_sc
    need = num_time * num_sc
    if num_time < 1 or num_sc < 1 or need > len(devices):
        raise ValueError(f"mesh {num_time}x{num_sc} needs {need} devices, "
                         f"have {len(devices)}")
    for d in devices[:need]:
        if d.type == "cuda" and (not torch.cuda.is_available() or (
                d.index or 0) >= torch.cuda.device_count()):
            raise RuntimeError(f"make_mesh: device {d} is not available")
    grid = np.empty((num_time, num_sc), dtype=object)
    for i, d in enumerate(devices[:need]):
        grid[i // num_sc, i % num_sc] = d
    return Mesh(grid)


def _blocks(x: torch.Tensor, mesh: Mesh):
    """x [S, T] (T a multiple of n_time) -> blocks[t][s] on each shard's
    device, contiguous."""
    n_time, n_sc = mesh.devices.shape
    Tloc = x.shape[-1] // n_time
    out = []
    for t in range(n_time):
        blk = x[:, t * Tloc:(t + 1) * Tloc]
        on = {}  # one copy per device: a row's shards share it
        for s in range(n_sc):
            d = mesh.devices[t, s]
            if d not in on:
                on[d] = blk.to(d).contiguous()
        out.append([on[mesh.devices[t, s]] for s in range(n_sc)])
    return out


def _padded_len(T: int, mesh: Mesh) -> int:
    """T padded up to a multiple of n_time * 128 (zeros: trailing silence
    is harmless to the decode), so every shard is equal-sized and a
    multiple of every coarse-sync stride."""
    q = mesh.shape["time"] * 128
    return -(-T // q) * q


def shard_capture(iq, mesh: Mesh):
    """A [S, T] complex64 capture (tensor or numpy) -> blocks[t][s]
    complex64 [S, Tloc], T zero-padded to a multiple of n_time * 128."""
    x = torch.as_tensor(iq).to(torch.complex64)
    T = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, _padded_len(T, mesh) - T))
    return _blocks(x, mesh)


def shard_capture_planes(iq, mesh: Mesh):
    """``shard_capture`` as (re, im) float32 planes: (re_blocks,
    im_blocks), for build_sharded_decoder(input_format="planes")."""
    x = torch.as_tensor(iq).to(torch.complex64)
    T = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, _padded_len(T, mesh) - T))
    return (_blocks(x.real.contiguous(), mesh),
            _blocks(x.imag.contiguous(), mesh))
