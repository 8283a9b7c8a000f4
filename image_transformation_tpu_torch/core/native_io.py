# Copy of image_transformation_tpu/core/native_io.py (host-only; imports rewritten to this package).
"""ctypes binding for the native PNG codec / batch ingest (native/png_io.cpp).

The C++ library decodes bundles directly into the zero-padded device-ready
tensor layout ([N, Hpad, Wpad, 4]) with a thread per file, and encodes
artifact PNGs without the PIL round-trip. Every entry point degrades
gracefully to PIL when the shared library isn't built (``make -C native``)
or a file uses a PNG feature outside the codec's subset (16-bit,
interlaced).
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def _find_library() -> Optional[Path]:
    candidates = [
        Path(__file__).resolve().parents[2] / "native" / "libpng_io.so",
        Path(os.environ.get("ITPU_NATIVE_LIB", "")),
    ]
    for p in candidates:
        if p and p.is_file():
            return p
    return None


def _try_build() -> None:
    """Best-effort `make -C native` when the source ships without the .so."""
    import subprocess

    native_dir = Path(__file__).resolve().parents[2] / "native"
    if not (native_dir / "png_io.cpp").is_file():
        return
    try:
        subprocess.run(
            ["make", "-C", str(native_dir)],
            check=False,
            capture_output=True,
            timeout=120,
        )
    except Exception:
        pass


def load_library() -> Optional[ctypes.CDLL]:
    """Load and memoize the native library; None if unavailable.

    Builds it on first use when only the C++ source is present (the .so is
    not checked in); every caller degrades to PIL if that fails.
    """
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = _find_library()
    if path is None:
        _try_build()
        path = _find_library()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.png_decode_rgba.restype = ctypes.c_int
    lib.png_decode_rgba.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.png_probe.restype = ctypes.c_int
    lib.png_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.png_encode_rgba.restype = ctypes.c_int64
    lib.png_encode_rgba.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.png_batch_decode_into_padded.restype = ctypes.c_int
    lib.png_batch_decode_into_padded.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return load_library() is not None


def probe_png(path) -> Optional[Tuple[int, int]]:
    """(width, height) via the native header probe; None -> fall back."""
    lib = load_library()
    if lib is None:
        return None
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    if lib.png_probe(os.fsencode(path), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    # unvalidated header dims: reject non-positive / absurd sizes here so
    # a corrupt PNG degrades to the PIL fallback instead of raising
    # MemoryError/ValueError out of a None-contract function
    wv, hv = int(w.value), int(h.value)
    if wv <= 0 or hv <= 0 or wv * hv > (1 << 28):
        return None
    return wv, hv


def decode_png_rgba(path) -> Optional[np.ndarray]:
    """Decode one PNG to uint8 [H, W, 4]; None -> fall back to PIL."""
    lib = load_library()
    if lib is None:
        return None
    probed = probe_png(path)
    if probed is None:
        return None
    w, h = probed
    buf = np.empty((h, w, 4), np.uint8)
    ow = ctypes.c_int32()
    oh = ctypes.c_int32()
    rc = lib.png_decode_rgba(
        os.fsencode(path),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        buf.nbytes,
        ctypes.byref(ow),
        ctypes.byref(oh),
    )
    if rc != 0 or (ow.value, oh.value) != (w, h):
        return None
    return buf


def encode_png_rgba(rgba: np.ndarray, path, level: int = 1) -> bool:
    """Write uint8 [H, W, 4] as PNG; False -> caller should fall back."""
    data = encode_png_rgba_bytes(rgba, level)
    if data is None:
        return False
    with open(path, "wb") as f:
        f.write(data)
    return True


def batch_decode_into_padded(
    paths: Sequence, n_slots: int, pad_hw: Tuple[int, int]
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Threaded decode of ``paths`` into ([n_slots, Hp, Wp, 4], [n_slots, 2]).

    Returns None if the native library is unavailable or any file fails
    (caller falls back to PIL for the whole batch — simplest correctness).
    """
    lib = load_library()
    if lib is None:
        return None
    pad_h, pad_w = pad_hw
    n = len(paths)
    if n > n_slots:
        raise ValueError(f"{n} paths > {n_slots} slots")
    if pad_h * pad_w > (1 << 28):
        # same envelope cap as Bundle.to_arrays: per-image probes can each
        # pass the 2^28-pixel check while their (max_h x max_w) cross
        # product demands an unbounded batch tensor
        raise ValueError(
            f"padded object envelope {pad_h}x{pad_w} exceeds the "
            f"2^28-pixel cap"
        )
    tensor = np.zeros((n_slots, pad_h, pad_w, 4), np.uint8)
    out_hw = np.zeros((n_slots, 2), np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = lib.png_batch_decode_into_padded(
        arr, n,
        tensor.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        pad_h, pad_w,
        out_hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        return None
    return tensor, out_hw


def encode_png_rgba_bytes(rgba: np.ndarray, level: int = 1) -> Optional[bytes]:
    """Encode uint8 [H, W, 4] to PNG bytes in memory (serving hot path);
    None -> caller should fall back to PIL."""
    lib = load_library()
    if lib is None:
        return None
    rgba = np.ascontiguousarray(rgba, np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        # the native encoder reads w*h*4 bytes; anything but [H, W, 4]
        # would be an out-of-bounds read — let the PIL fallback raise its
        # clean mode error instead
        return None
    h, w = rgba.shape[:2]
    src = rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    cap = lib.png_encode_rgba(src, w, h, level, None, 0)
    if cap <= 0:
        return None
    out = np.empty((int(cap),), np.uint8)
    n = lib.png_encode_rgba(
        src, w, h, level,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.nbytes,
    )
    if n <= 0:
        return None
    return out[: int(n)].tobytes()


def png_bytes(rgba: np.ndarray, level: int = 1) -> bytes:
    """PNG bytes via the native encoder, PIL fallback."""
    encoded = encode_png_rgba_bytes(rgba, level)
    if encoded is not None:
        return encoded
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgba, np.uint8), "RGBA").save(
        buf, format="PNG"
    )
    return buf.getvalue()


def save_png(rgba: np.ndarray, path, level: int = 1) -> None:
    """Artifact writer: native encoder with PIL fallback."""
    if encode_png_rgba(rgba, path, level):
        return
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(rgba, np.uint8), "RGBA").save(path)
