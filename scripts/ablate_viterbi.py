#!/usr/bin/env python3
"""Where the Viterbi kernel's time goes, on one NVIDIA GPU: its forward
pass against its traceback, per warp, in cycles a step.

    python3 scripts/ablate_viterbi.py [--steps 4352]

Builds a copy of rub_mimo_tpu_torch/kernels/csrc/viterbi.cu with a
clock64() mark at each warp's start, after its forward pass and after its
traceback (into rub_mimo_tpu_torch/_build/), runs it on seeded LLR pairs
of the operating point's window length at two shapes: the in-place
8-lane path alone (one warp an SM partition: 2,112 rows) and the
operating point's 2,500 rows (in-place warps and one-row warps side by
side).  Prints the card line, then one JSON line a shape: the median and
largest cycles a step of each pass over the warps, split by kind of
warp.  The marks add a few instructions
a warp; times from ``scripts/time_viterbi.py`` are the kernel's own.
Exits non-zero without a CUDA device."""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
WARP_SLOTS = 1 << 14

HELPER = r'''
__device__ long long g_clk[%d][3];
__device__ __forceinline__ void clk_mark(int idx) {
  if ((threadIdx.x & 31) == 0) {
    const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    g_clk[w][idx] = clock64();
  }
}
''' % WARP_SLOTS
READER = r'''
extern "C" int read_clk(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_clk, n * 3 * sizeof(long long));
}
extern "C" int zero_clk(const long long* host, int n) {
  return (int)cudaMemcpyToSymbol(g_clk, host, n * 3 * sizeof(long long));
}
'''


def instrumented_source() -> str:
    """csrc/viterbi.cu with the three marks in both warp paths."""
    src = (REPO / "rub_mimo_tpu_torch/kernels/csrc/viterbi.cu").read_text()
    src = src.replace("namespace {\n", "namespace {\n" + HELPER, 1)
    src = src.replace("  const bool pin = pinned[row] != 0;\n",
                      "  const bool pin = pinned[row] != 0;\n  clk_mark(0);\n")
    src = src.replace("  // start: state 0,", "  clk_mark(1);\n  // start: state 0,")
    for tail in ("    word = ahead;\n  }\n}",
                 "      if (live && t < T) out[t] = bit[u];\n    }\n  }\n}"):
        src = src.replace(tail, tail[:-1] + "  clk_mark(2);\n}")
    if src.count("clk_mark(") != 7:
        raise SystemExit("ablate_viterbi.py: the kernel's source no longer "
                         "has the places the marks go")
    return src + READER


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4352)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_viterbi.py: no CUDA device")
    sys.path.insert(0, str(REPO))
    from chip_smoke import card_line
    from rub_mimo_tpu_torch.kernels import _build

    print(card_line(), flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "viterbi_marked.cu"
    lib_path = _build.BUILD_DIR / "viterbi_marked.so"
    cu.write_text(instrumented_source())
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.viterbi.argtypes = [P, P, I, I, P, P, P]
    lib.read_clk.argtypes = lib.zero_clk.argtypes = [P, I]
    dev = torch.device("cuda")
    T = args.steps
    rng = np.random.default_rng(T)
    pairs = torch.as_tensor(
        (rng.standard_normal((2500, T, 2)) * 2.0).astype(np.float32),
        device=dev)
    zero = np.zeros((WARP_SLOTS, 3), np.int64)
    for name, rows in (("inplace_alone", 2112),
                       ("operating_point", 2500)):
        p = pairs[:rows].contiguous()
        pin = torch.zeros(rows, dtype=torch.uint8, device=dev)
        dec = torch.empty((rows, 4 * (-(-T // 4))), dtype=torch.int64,
                          device=dev)
        bits = torch.empty((rows, T), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(2):  # the second launch's marks are read
            if lib.zero_clk(zero.ctypes.data, WARP_SLOTS) != 0:
                raise SystemExit("ablate_viterbi.py: clearing the marks")
            if lib.viterbi(p.data_ptr(), pin.data_ptr(), rows, T,
                           dec.data_ptr(), bits.data_ptr(),
                           stream) != 0:
                raise SystemExit("ablate_viterbi.py: launch failed")
        torch.cuda.synchronize()
        buf = np.zeros((WARP_SLOTS, 3), np.int64)
        if lib.read_clk(buf.ctypes.data, WARP_SLOTS) != 0:
            raise SystemExit("ablate_viterbi.py: reading the marks")
        ran = (buf[:, 0] > 0) & (buf[:, 2] > buf[:, 1]) & (
            buf[:, 1] > buf[:, 0])
        warp = np.arange(WARP_SLOTS)[ran]
        fwd = (buf[ran, 1] - buf[ran, 0]) / T
        back = (buf[ran, 2] - buf[ran, 1]) / T
        # blocks of 4 in-place warps, then 4 one-row warps
        kinds = {"inplace": warp % 8 < 4, "one_row": warp % 8 >= 4}
        out = {"shape": name, "rows": rows, "steps": T}
        for kind, sel in kinds.items():
            if sel.any():
                out[kind] = {
                    "warps": int(sel.sum()),
                    "forward_cycles_a_step": [float(np.median(fwd[sel])),
                                              float(fwd[sel].max())],
                    "traceback_cycles_a_step": [float(np.median(back[sel])),
                                                float(back[sel].max())]}
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
