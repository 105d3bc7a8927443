"""Extract liquid-dsp's exact modem tables at runtime via ctypes.

Port of rub_mimo_tpu/ofdm/liquid_tables.py (ctypes and numpy only); the
table is installed through rub_mimo_tpu_torch.ofdm.constellation.

The reference modulates payloads with LIQUID_MODEM_ARB32OPT
(mimo/config.h:107-108, mimo/main.cc:1203-1204) — liquid's hand-tuned
"optimal" 32-point constellation.  Decoding a capture RECORDED by the
reference symbol-exactly requires liquid's exact floats; this repo ships
its own optimized 32-point table (constellation.optimal_constellation,
better min-distance but not float-identical) plus an external-table
loader.  This module closes the remaining gap wherever liquid-dsp is
actually installed: it dlopens ``libliquid``, resolves the scheme by
NAME (``liquid_getopt_str2mod`` — no hardcoded enum values, those shift
between liquid versions), modulates all 32 symbols through a real
``modem`` object, and installs the resulting exact table.

liquid's exact floats are not vendored: they are read from an installed
liquid-dsp.  ``scripts/extract_liquid_arb32opt.py`` dumps the table to a
file on a machine that has liquid, to ship with the captures
(``--arb32opt-table``).
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np


class LiquidNotFound(RuntimeError):
    pass


def _open_libliquid(path: str | None = None):
    name = path or ctypes.util.find_library("liquid")
    if name is None:
        # find_library needs ldconfig/gcc; also try the bare soname
        for cand in ("libliquid.so", "libliquid.so.1", "libliquid.dylib"):
            try:
                return ctypes.CDLL(cand)
            except OSError:
                continue
        raise LiquidNotFound(
            "liquid-dsp shared library not found (install liquid-dsp or "
            "pass the path explicitly)"
        )
    try:
        return ctypes.CDLL(name)
    except OSError as e:
        raise LiquidNotFound(f"failed to dlopen {name}: {e}") from e


def extract_modem_table(scheme: str = "arb32opt",
                        lib_path: str | None = None) -> np.ndarray:
    """Modulate every symbol of a liquid modem scheme and return the
    exact constellation as complex64 [arity].

    scheme: liquid's print name, e.g. "arb32opt" (resolved via
    liquid_getopt_str2mod, so it matches whatever liquid build is
    installed — the same table the reference's modem_create used,
    main.cc:1203-1204).
    """
    lib = _open_libliquid(lib_path)

    lib.liquid_getopt_str2mod.restype = ctypes.c_int
    lib.liquid_getopt_str2mod.argtypes = [ctypes.c_char_p]
    ms = lib.liquid_getopt_str2mod(scheme.encode())
    if ms <= 0:  # LIQUID_MODEM_UNKNOWN == 0
        raise LiquidNotFound(f"liquid does not know scheme {scheme!r}")

    # modem_create returns an opaque pointer; modem_modulate writes one
    # float complex (two f32) through the out pointer.  Newer liquid
    # renames the type to modemcf with aliases kept — the symbol names
    # below exist in both.
    lib.modem_create.restype = ctypes.c_void_p
    lib.modem_create.argtypes = [ctypes.c_int]
    lib.modem_modulate.restype = None
    lib.modem_modulate.argtypes = [
        ctypes.c_void_p, ctypes.c_uint, ctypes.POINTER(ctypes.c_float * 2)
    ]
    lib.modem_destroy.restype = None
    lib.modem_destroy.argtypes = [ctypes.c_void_p]

    q = lib.modem_create(ms)
    if not q:
        raise LiquidNotFound(f"modem_create({scheme!r}) returned NULL")
    try:
        # arity from the scheme's bits/symbol
        lib.modem_get_bps.restype = ctypes.c_uint
        lib.modem_get_bps.argtypes = [ctypes.c_void_p]
        arity = 1 << int(lib.modem_get_bps(q))
        out = np.empty(arity, dtype=np.complex64)
        buf = (ctypes.c_float * 2)()
        for s in range(arity):
            lib.modem_modulate(q, s, ctypes.byref(buf))
            out[s] = complex(buf[0], buf[1])
        return out
    finally:
        lib.modem_destroy(q)


def install_liquid_arb32opt(lib_path: str | None = None) -> np.ndarray:
    """Extract liquid's exact ARB32OPT table and install it into the
    ARB32OPT constellation slot (symbol-index-faithful: point s is what
    liquid's modem_modulate(s) emits, so demod indices match the
    reference's tx_data logs bit-for-bit).  Raises LiquidNotFound when
    liquid-dsp is not installed."""
    from rub_mimo_tpu_torch.ofdm import constellation

    pts = extract_modem_table("arb32opt", lib_path)
    if pts.shape[0] != 32:
        raise LiquidNotFound(f"arb32opt arity mismatch: {pts.shape[0]}")
    constellation.set_arb32opt_table(pts)
    return pts
