"""Schmidl&Cox timing metric over a whole capture (K6).

Port of rub_mimo_tpu/kernels/sc_metric.py::sc_metric_pallas.  On CUDA
tensors ``sc_metric_fused`` launches the hand-written Hopper kernel
csrc/sc_metric.cu (one pass: each tile loads its own M-sample halo and
takes chunk-local prefix-sum differences in shared memory, see the
source note); on CPU tensors it runs ``sc_metric_reference``, the plain
moving-sum version that the tests and chip_smoke.py hold the kernel
against.  There is no fallback: a CUDA call that the kernel cannot take,
or whose build or launch fails, raises.

The plain moving sums here are also the ones sync.schmidl_cox uses for
its correlation (the CFO observable).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rub_mimo_tpu_torch.utils.movsum import delay, moving_sum


def moving_corr_energy(x: torch.Tensor, M: int, *, block: int = 1 << 15):
    """The S&C moving sums for rows x [..., T] complex (framing.cc:626-637):
    corr[t] = -sum_{k<M/2} conj(x[t-k-M/2]) x[t-k] (complex64) and
    energy[t] = 0.5 sum_{k<M} |x[t-k]|^2 (float32), zeros before t=0."""
    M2 = M // 2
    prod = torch.conj(delay(x, M2)) * x
    corr = -moving_sum(prod, M2, block=block)
    energy = 0.5 * moving_sum(x.real ** 2 + x.imag ** 2, M, block=block)
    return corr, energy


def metric_from(corr: torch.Tensor, energy: torch.Tensor) -> torch.Tensor:
    """|corr|^2 / energy^2: NaN where the window is all zeros."""
    return (corr.real ** 2 + corr.imag ** 2) / (energy * energy)


def sc_metric_reference(x: torch.Tensor, M: int, *,
                        block: int = 1 << 15) -> torch.Tensor:
    """Plain PyTorch S&C metric [S, T] float32 of x [S, T] complex64."""
    return metric_from(*moving_corr_energy(x, M, block=block))


def supported(M: int) -> bool:
    """Geometry gate of the CUDA S&C kernels (K5, K6): M a multiple of 32
    in [32, 4096]."""
    return 32 <= M <= 4096 and M % 32 == 0


def check_capture(name: str, x: torch.Tensor, M: int, max_streams: int):
    """Raise ValueError for a capture the CUDA S&C kernels do not take."""
    if x.dtype != torch.complex64:
        raise ValueError(f"{name}: x must be complex64, got {x.dtype}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= max_streams:
        raise ValueError(f"{name}: x must be [S, T] with 1 <= S <= "
                         f"{max_streams}, got {tuple(x.shape)}")
    if not 1 <= x.shape[1] < (1 << 30):
        raise ValueError(f"{name}: need 1 <= T < 2**30, got {x.shape[1]}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if not supported(M):
        raise ValueError(f"{name}: the kernel does not take M={M} "
                         "(a multiple of 32 in [32, 4096])")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from rub_mimo_tpu_torch.kernels import _build

    fn = _build.load("sc_metric").sc_metric
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I, I, P, P]
    fn.restype = I
    return fn


def sc_metric_fused(x: torch.Tensor, M: int, *,
                    block: int = 1 << 15) -> torch.Tensor:
    """S&C metric [S, T] float32 of x [S, T] complex64.

    ``block`` is the chunk of the plain version's moving sums (CPU
    tensors); the kernel's tiles are its own."""
    if x.device.type == "cpu":
        return sc_metric_reference(x, M, block=block)
    if x.device.type != "cuda":
        raise ValueError(f"sc_metric_fused: no kernel for {x.device}")
    check_capture("sc_metric_fused", x, M, 65535)
    S, T = x.shape
    fn = _kernel_fn()
    metric = torch.empty((S, T), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), S, T, M, metric.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sc_metric kernel launch failed: CUDA error {err}")
    sc_metric_fused.launches += 1
    return metric


sc_metric_fused.launches = 0
