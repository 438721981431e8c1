"""ctypes bindings of the port's native host runtime
(`utils/csrc/bls_host.cpp`): batched Fp byte codecs with the Montgomery
conversion, and a batched expand_message_xmd over SHA-256.

The library is built at first use by `kernels/build.py` (`build_host`: the
host C++ compiler, into the git-ignored `kernels/_build/`).  A failed build
is not hidden: every function raises RuntimeError with the compiler's
output, and `available()` only reports whether the library built.  Host
code only; values equal `hostmath`'s (tests/test_torch_native.py).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "bls_host.cpp"
_P, _N = ctypes.c_void_p, ctypes.c_size_t
_SIGNATURES = {
    "bls_fp_from_bytes": (_P, _N, ctypes.c_int, _P, _P),
    "bls_fp_to_bytes": (_P, _N, ctypes.c_int, _P),
    "bls_expand_msg_xmd_sha256": (_P, _P, _N, _P, _N, _N, _P),
}

_LIB = None
_ERROR = None


def _load() -> ctypes.CDLL:
    """The loaded library, built first if stale; the first failure's
    RuntimeError on every call after it."""
    global _LIB, _ERROR
    if _LIB is None and _ERROR is None:
        try:
            lib = ctypes.CDLL(str(build.build_host(SOURCE)))
        except (RuntimeError, OSError) as exc:
            _ERROR = str(exc)
        else:
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIB = lib
    if _LIB is None:
        raise RuntimeError(_ERROR)
    return _LIB


def available() -> bool:
    """Whether the library built (and loaded)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _rows(a, dtype, shape: str, ok) -> np.ndarray:
    """a as a contiguous array of dtype, or ValueError where its shape is
    not the one the C function reads."""
    a = np.ascontiguousarray(a, dtype=dtype)
    if a.ndim != 2 or not ok(a.shape):
        raise ValueError(f"expected an array of shape {shape}, got "
                         f"{a.shape}")
    return a


def fp_from_bytes(data: np.ndarray, to_mont: bool = True):
    """uint8[n, 48] big-endian -> (uint32[24, n] 16-bit limbs, limb axis
    first, in Montgomery form when to_mont; bool[n]: the value is < p).
    A non-canonical row's limbs are those of 0."""
    data = _rows(data, np.uint8, "[n, 48]", lambda s: s[1] == 48)
    lib = _load()
    n = data.shape[0]
    out = np.empty((24, n), dtype=np.uint32)
    ok = np.empty(n, dtype=np.uint8)
    lib.bls_fp_from_bytes(_ptr(data), n, int(to_mont), _ptr(out), _ptr(ok))
    return out, ok.astype(bool)


def fp_to_bytes(limbs: np.ndarray, from_mont: bool = True) -> np.ndarray:
    """uint32[24, n] limbs (Montgomery form when from_mont) -> uint8[n, 48]
    big-endian canonical."""
    limbs = _rows(limbs, np.uint32, "[24, n]", lambda s: s[0] == 24)
    lib = _load()
    n = limbs.shape[1]
    out = np.empty((n, 48), dtype=np.uint8)
    lib.bls_fp_to_bytes(_ptr(limbs), n, int(from_mont), _ptr(out))
    return out


def expand_message_xmd_sha256(msgs: list[bytes], dst: bytes,
                              len_in_bytes: int) -> np.ndarray:
    """expand_message_xmd (draft-16 §5.3.1, SHA-256) of each message:
    uint8[n, len_in_bytes]; ValueError where len_in_bytes is out of range
    (over 65535, or over 255 blocks of 32 bytes)."""
    lib = _load()
    offsets = np.zeros(len(msgs) + 1, dtype=np.uint64)
    np.cumsum([len(m) for m in msgs], out=offsets[1:])
    # one-byte placeholders keep the pointers valid for empty inputs
    blob = np.frombuffer(b"".join(msgs) or b"\0", dtype=np.uint8)
    dst_arr = np.frombuffer(dst or b"\0", dtype=np.uint8)
    out = np.empty((len(msgs), len_in_bytes), dtype=np.uint8)
    rc = lib.bls_expand_msg_xmd_sha256(_ptr(blob), _ptr(offsets), len(msgs),
                                       _ptr(dst_arr), len(dst), len_in_bytes,
                                       _ptr(out))
    if rc != 0:
        raise ValueError("expand_message_xmd: len_in_bytes out of range")
    return out
