"""Batched serving: a batch of captures spread over the mesh (port of
rub_mimo_tpu/parallel/serving.py).

parallel.decode_sharded speeds up one capture by sharding its time axis;
this is the other axis of scale, many independent captures at once.  It
is pure data parallelism with no collective: each capture is decoded by
the port's single-device decoder (pipeline.rx.make_decoder) on the
device of the mesh shard that holds it, with its own sync point and its
own channel estimate, and the results are stacked.
"""

from __future__ import annotations

import torch

from rub_mimo_tpu_torch.config import ModemConfig
from rub_mimo_tpu_torch.parallel.mesh import Mesh
from rub_mimo_tpu_torch.pipeline import rx


def _axis_devices(mesh: Mesh, axis: str):
    if axis not in mesh.shape:
        raise ValueError(f"unknown mesh axis {axis!r}")
    if mesh.spans_processes:
        raise ValueError("batched serving runs on one controller: the mesh "
                         "spans processes")
    return list(mesh.devices[:, 0] if axis == "time" else mesh.devices[0, :])


def shard_batch(iq_batch, mesh: Mesh, axis: str = "time"):
    """A [batch, streams, T] stack -> a list of [batch/n, streams, T]
    complex64 blocks, block i on the device of shard i along ``axis``;
    batch must be a multiple of that axis' size n."""
    devices = _axis_devices(mesh, axis)
    x = torch.as_tensor(iq_batch).to(torch.complex64)
    n = len(devices)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} must be a multiple of the "
                         f"'{axis}' axis size {n}")
    per = x.shape[0] // n
    return [x[i * per:(i + 1) * per].to(d) for i, d in enumerate(devices)]


def make_sharded_batch_decoder(cfg: ModemConfig, mesh: Mesh,
                               axis: str = "time"):
    """A decoder of batches laid out by ``shard_batch``: returns the
    batched rx.DecodeResult (every field stacked on a leading batch dim,
    on the mesh's home device)."""
    devices = _axis_devices(mesh, axis)
    decoders = {d: rx.make_decoder(cfg, device=d)
                for d in dict.fromkeys(devices)}

    def decode_batch(blocks):
        if len(blocks) != len(devices):
            raise ValueError(f"expected {len(devices)} blocks, got "
                             f"{len(blocks)}")
        results = [decoders[d](iq) for d, blk in zip(devices, blocks)
                   for iq in blk]
        return rx.DecodeResult(*(
            None if results[0][i] is None else
            torch.stack([r[i].to(mesh.home) for r in results])
            for i in range(len(results[0]))))

    return decode_batch
