"""The port's fused compose kernels, their wrappers and plain versions.

Counterpart of image_transformation_tpu/ops/compose_pallas.py (gen-2 at
:2456-2722, gen-3 and the window restore at :745-826 and :3541-4138). The
kernels are CUDA C++ for sm_90a under ``csrc/``; every wrapper launches
its kernel for a CUDA tensor (or raises) and runs its plain PyTorch version
for a CPU tensor, and raises ``LAUNCHES[name]`` by one per launching call.

K1, the gen-2 contract (``csrc/fused_compose.cu``): exact resample from
host-built Pillow tables, then alpha-over, on u8 RGBA canvases.

- :func:`fused_tables_prep`: Pillow-exact int32 tables and live/identity
  flags, in the layout K1 takes;
- :func:`fused_compose` (wrapper) and :func:`fused_compose_reference`.

K2, the gen-3 contract (``csrc/fused_v3.cu``): tables built on the device
from four sizes per object (meta columns 6-9), resample, alpha-over into
the padded packed int32 plane. K3 (``csrc/restore_windows.cu``): fill of
the previous render's windows with the background, a solid colour or a
:class:`GradientRamp`.

- geometry and packing: :func:`window_extents`, :func:`fused_canvas_pad_hw`,
  :class:`RenderGeometry` (built by :func:`render_geometry`: a render's
  envelope, plane and windows, and its meta), :func:`planarize_objects`,
  :func:`pack_rgba_scalar`;
- :func:`fused_v3` / :func:`fused_v3_reference` (K2 walks only the live
  tiles of its placements, counted by the plain :func:`_v3_live_tiles`),
  :func:`restore_windows` / :func:`restore_windows_reference`;
- :func:`render_fused_v3_step`, the one restore-then-compose code, which the
  programs and ``parallel.sweep``'s render step run;
- the programs: :func:`composite_batch_fused_v3`,
  :func:`render_fused_v3_program` and :func:`render_fused_v3_reuse_program`
  (either background), and their named forms
  :func:`render_solid_fused_v3_program`,
  :func:`render_solid_fused_v3_reuse_program` and
  :func:`render_gradient_fused_v3_program` (per-canvas colours).

K4, the two-program hybrid (``csrc/window_blend.cu``; JAX :1029-1207,
:1210-2084, :2144-2453): a plain-torch producer resizes every object into
sources ``[B, N, mh, mw]`` and pads the canvases into the plane; K4
alpha-overs the sources onto the plane through their windows, in two
launches: bounds (each placement's box of nonzero source pixels,
:func:`k4_live_rects_reference`), then a z-order blend over those boxes.

- the producers :func:`_hybrid_producer` (unclamped, the plane padded by a
  window), :func:`_hybrid_producer_clamped`, :func:`_hybrid_producer_rowbaked`
  (dy baked into the sources), :func:`_hybrid_producer_aligned` (dy and dx
  baked) and :func:`_hybrid_producer_planar` (planar u8);
- :func:`window_blend` / :func:`window_blend_reference` (packed int32),
  behind the named counterparts of the TPU launchers of rows 3-11;
  :func:`window_blend_planar` / :func:`window_blend_planar_reference` (row
  2); :func:`window_blend_stage` / :func:`window_blend_stage_reference`, the
  timing-only stage variants of row 15;
- :func:`composite_batch_hybrid_packed` (every flag),
  :func:`composite_batch_aligned`, :func:`composite_batch_hybrid`.

The run statistic (``csrc/packed_luma.cu``, no TPU kernel: JAX leaves the
reduction to XLA): :func:`packed_luma` / :func:`packed_luma_reference`,
each canvas's mean Rec.709 luminance of a packed crop from one read of it.

K1 also carries the gen-1 planar compose (row 1): :func:`_pallas_compose_planar`,
:func:`composite_batch_pallas` and :func:`composite_batch_pallas_host_tables`.

The packed plane is a signed int32 ``[B, hp, wp]`` whose little-endian bytes
are RGBA; the kernels update it in place where JAX donates it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.timing import launch_range, span
from .compose import _blend_window, alpha_over_u8
from .resize import (
    UPSCALE_TAPS,
    _grows,
    build_coeffs_host,
    build_coeffs_traced,
    build_coeffs_v3,
    premultiply_rgba,
    resample_fixed,
    resize_f32_shifted,
    resize_u8,
    resize_with_tables,
    unpremultiply_rgba,
    upscale_tap_windows,
)

FLAG_LIVE = 1
FLAG_IDENTITY = 2

#: launches since the last reset (one per launching wrapper call on CUDA;
#: "fused_v3_chunks" counts each chunk a K2 call launches over,
#: "fused_v3_tables" each chunk that ran K2's table stage: a mixed launch's,
#: "fused_v3_walks" each launch of K2's resample, which walks the live
#: tiles of at most as many placements as its prefix fits: one a chunk, or
#: more where a chunk's placements pass that cap; "fused_v3_own_objects"
#: each chunk whose objects are per canvas, Bo == B > 1; and
#: "restore_windows_lines" each K3 ramp launch with a line per canvas)
LAUNCHES = {"fused_compose": 0, "fused_v3": 0, "fused_v3_chunks": 0, "fused_v3_tables": 0,
            "fused_v3_walks": 0, "fused_v3_own_objects": 0, "restore_windows": 0,
            "restore_windows_lines": 0, "window_blend": 0, "window_blend_planar": 0,
            "window_blend_stage": 0, "packed_luma": 0}

_MAX_GRID_X = (1 << 31) - 1  # CUDA's limit on gridDim.x, which carries B*N
_MAX_GRID_Z = 65535  # CUDA's limit on gridDim.y and gridDim.z


def _stream_handle(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer handle. A K1 call
    at B=1 is host-bound, and torch's raw-stream query takes 0.1-0.3 us
    where ``torch.cuda.current_stream(device).cuda_stream`` takes 3.4-7.2
    us (it builds a Stream object; tools/profile_k1.py on an H100 host); the
    public call stands in if a torch release drops the private one."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(device.index) if raw is not None else torch.cuda.current_stream(device).cuda_stream


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fused_tables_prep(
    obj_hw: np.ndarray,
    boxes: np.ndarray,
    canvas_hw: Tuple[int, int],
    obj_pad_hw: Tuple[int, int],
    out_max_hw: Tuple[int, int],
    method: str = "lanczos",
):
    """Host side of the exact fused compose (Pillow tables of ``method``).

    obj_hw [B, N, 2] (h, w) and boxes [B, N, 4] (x1, y1, x2, y2) are host
    ints. Returns numpy (kh i32 [B, N, mw, pw], kv i32 [B, N, mh, ph],
    boxes i32 [B, N, 4], flags u8 [B, N]) with (mh, mw) = out_max_hw and
    (ph, pw) = obj_pad_hw. A box resamples to max(1, x2-x1) x
    max(1, y2-y1); a placement whose origin is negative or off the canvas
    is not live (dropped); identity marks Pillow's plain-copy shortcut.
    """
    obj_hw = np.asarray(obj_hw, np.int64)
    boxes = np.asarray(boxes, np.int64)
    B, N = boxes.shape[0], boxes.shape[1]
    h_c, w_c = canvas_hw
    ph, pw = obj_pad_hw
    mh, mw = out_max_hw
    kh = np.zeros((B, N, mw, pw), np.int32)
    kv = np.zeros((B, N, mh, ph), np.int32)
    flags = np.zeros((B, N), np.uint8)
    for b in range(B):
        for k in range(N):
            x1, y1, x2, y2 = (int(v) for v in boxes[b, k])
            w_t, h_t = max(1, x2 - x1), max(1, y2 - y1)
            oh, ow = int(obj_hw[b, k, 0]), int(obj_hw[b, k, 1])
            kh[b, k] = build_coeffs_host(ow, w_t, pw, mw, method)
            kv[b, k] = build_coeffs_host(oh, h_t, ph, mh, method)
            drop = x1 < 0 or y1 < 0 or x1 >= w_c or y1 >= h_c
            flags[b, k] = (0 if drop else FLAG_LIVE) | (
                FLAG_IDENTITY if (w_t == ow and h_t == oh) else 0
            )
    return kh, kv, boxes.astype(np.int32), flags


_K1_DTYPES = (torch.uint8, torch.uint8, torch.int32, torch.int32, torch.int32, torch.uint8)


def _check_args(canvas, objects, kh, kv, boxes, flags) -> None:
    """Raise on anything K1 does not take: device, dtype, shape, layout."""
    args = (canvas, objects, kh, kv, boxes, flags)
    names = ("canvas", "objects", "kh", "kv", "boxes", "flags")
    for name, t, dtype in zip(names, args, _K1_DTYPES):
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != canvas.device:
            raise ValueError(f"{name} is on {t.device}, canvas on {canvas.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    cs, osh, khs, kvs = canvas.shape, objects.shape, kh.shape, kv.shape
    if len(cs) != 4 or cs[3] != 4:
        raise ValueError(f"canvas must be [B, H, W, 4], got {tuple(cs)}")
    B = cs[0]
    if len(osh) != 5 or osh[4] != 4 or osh[0] not in (1, B):
        raise ValueError(f"objects must be [1 or B, N, ph, pw, 4], got {tuple(osh)}")
    _, N, ph, pw, _ = osh
    if len(khs) != 4 or khs[0] != B or khs[1] != N or khs[3] != pw:
        raise ValueError(f"kh must be [B, N, mw, pw], got {tuple(khs)}")
    if len(kvs) != 4 or kvs[0] != B or kvs[1] != N or kvs[3] != ph:
        raise ValueError(f"kv must be [B, N, mh, ph], got {tuple(kvs)}")
    if boxes.shape != (B, N, 4):
        raise ValueError(f"boxes must be [B, N, 4], got {tuple(boxes.shape)}")
    if flags.shape != (B, N):
        raise ValueError(f"flags must be [B, N], got {tuple(flags.shape)}")


def fused_compose_reference(
    canvas: torch.Tensor,
    objects: torch.Tensor,
    kh: torch.Tensor,
    kv: torch.Tensor,
    boxes: torch.Tensor,
    flags: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of K1 (float64 matmuls, int32 elementwise),
    looping over (b, k). Updates ``canvas`` in place and returns it."""
    _check_args(canvas, objects, kh, kv, boxes, flags)
    boxes_h = boxes.tolist()
    flags_h = flags.tolist()
    shared = objects.shape[0] == 1
    for b in range(canvas.shape[0]):
        for k in range(objects.shape[1]):
            f = flags_h[b][k]
            if not f & FLAG_LIVE:
                continue
            resized = resize_with_tables(
                objects[0 if shared else b, k], kh[b, k], kv[b, k],
                bool(f & FLAG_IDENTITY),
            )
            _blend_window(canvas[b], resized, boxes_h[b][k][0], boxes_h[b][k][1])
    return canvas


_ARGTYPES = {
    "fused_compose_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    "fused_compose_scratch_bytes": [ctypes.c_int] * 4,
    "fused_compose_bounds_slices": [ctypes.c_int] * 2,
    "fused_compose_smem": [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "fused_compose_bounds_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "fused_v3_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2,
    "fused_v3_tables_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "fused_v3_grid": [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "fused_v3_h_tally": [ctypes.c_void_p],
    "restore_windows_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "restore_windows_ramp_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "restore_windows_smem": [ctypes.c_int],
    "window_blend_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "window_blend_planar_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "window_blend_stage_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "window_blend_bounds_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "window_blend_scratch_bytes": [ctypes.c_int] * 3,
    "window_blend_slices": [ctypes.c_int, ctypes.c_void_p],
    "window_blend_smem": [ctypes.c_int, ctypes.c_void_p],
    "packed_luma_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2
                          + [ctypes.c_int] + [ctypes.c_double] * 4 + [ctypes.c_void_p],
}
_RESTYPES = {"fused_compose_scratch_bytes": ctypes.c_longlong,
             "window_blend_scratch_bytes": ctypes.c_longlong}


_ENTRIES = {}
_ENTRIES_LOCK = threading.Lock()


def _kernel_entry(name: str):
    """The C entry ``name`` of the kernels' library (built on first use),
    with its argument and result types set: pointers and the stream as
    c_void_p, the result a CUDA error code unless ``_RESTYPES`` says else.
    Thread-safe: an entry is published only once its types are set."""
    fn = _ENTRIES.get(name)
    if fn is None:
        from ._build import load_library

        with _ENTRIES_LOCK:
            fn = _ENTRIES.get(name)
            if fn is None:
                fn = getattr(load_library(), name)
                fn.argtypes = _ARGTYPES[name]
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
                _ENTRIES[name] = fn
    return fn


def _device_guard(dev: torch.device):
    """``torch.cuda.device(dev)`` where ``dev`` is not the current device, else
    nothing: a wrapper call at a small size is host-bound, and the guard
    costs 2-5 us where checking the current device first costs ~1 (PERF.md)."""
    return (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
            else torch.cuda.device(dev))


def fused_compose(
    canvas: torch.Tensor,
    objects: torch.Tensor,
    kh: torch.Tensor,
    kv: torch.Tensor,
    boxes: torch.Tensor,
    flags: torch.Tensor,
) -> torch.Tensor:
    """Resample every live object with its tables and alpha-over it onto
    its canvas, in list order. Updates ``canvas`` IN PLACE and returns it.

    canvas  u8  [B, H, W, 4]
    objects u8  [Bo, N, ph, pw, 4], Bo == 1 (shared) or B
    kh      i32 [B, N, mw, pw];  kv i32 [B, N, mh, ph]
    boxes   i32 [B, N, 4];       flags u8 [B, N] (FLAG_LIVE | FLAG_IDENTITY)

    On a CUDA device this launches K1 on the current stream (no
    synchronisation) and raises if the launch fails; on the CPU it runs
    :func:`fused_compose_reference`. Inputs are checked and anything else
    raises.
    """
    if canvas.device.type == "cpu":
        return fused_compose_reference(canvas, objects, kh, kv, boxes, flags)
    _check_args(canvas, objects, kh, kv, boxes, flags)
    if canvas.device.type != "cuda":
        raise ValueError(f"fused_compose runs on cuda or cpu, not {canvas.device}")
    B, H, W, _ = canvas.shape
    Bo, N, ph, pw, _ = objects.shape
    mw, mh = kh.shape[2], kv.shape[2]
    if min(B, H, W, N, ph, pw, mh, mw) == 0:
        return canvas
    if canvas.data_ptr() % 4 or objects.data_ptr() % 4:
        raise ValueError("canvas and objects must be 4-byte aligned (uchar4 pixels)")
    fn = _kernel_entry("fused_compose_launch")
    dev = canvas.device
    # one buffer, carved by the launch: table windows, extent parts,
    # rectangles, resampled objects
    scratch = torch.empty(_k1_scratch_bytes(B, N, mh, mw), dtype=torch.uint8, device=dev)
    with _device_guard(dev):
        rc = fn(
            canvas.data_ptr(), objects.data_ptr(), kh.data_ptr(), kv.data_ptr(),
            boxes.data_ptr(), flags.data_ptr(), scratch.data_ptr(),
            B, Bo, N, H, W, ph, pw, mh, mw, _stream_handle(dev),
        )
    del scratch  # freed to the caching allocator, in stream order
    if rc != 0:
        raise RuntimeError(f"fused_compose: kernel launch failed with CUDA error {rc}")
    LAUNCHES["fused_compose"] += 1
    return canvas


@functools.lru_cache(maxsize=256)
def _k1_scratch_bytes(B: int, N: int, mh: int, mw: int) -> int:
    """Bytes of scratch one K1 call takes, as its launch carves it."""
    return _kernel_entry("fused_compose_scratch_bytes")(B, N, mh, mw)


def launch_smem(kernel: str, ph: int, pw: int, n: int) -> Tuple[int, ...]:
    """Dynamic shared memory (bytes) of each launch of K1 (``kernel``
    "fused_compose": bounds, resample, blend), K4 ("window_blend": bounds,
    blend) or K3 ("restore_windows") for objects padded to (ph, pw), ``n``
    per canvas, as the launches size it (K3 and K4 ignore the pad; K2's
    walks: :func:`_v3_grid`)."""
    if kernel == "restore_windows":
        return (_kernel_entry("restore_windows_smem")(n),)
    out = (ctypes.c_int * {"fused_compose": 3, "window_blend": 2}[kernel])()
    if kernel == "window_blend":
        _kernel_entry("window_blend_smem")(n, out)
    else:
        _kernel_entry(f"{kernel}_smem")(ph, pw, n, out)
    return tuple(out)


def k1_tap_windows_reference(kh: torch.Tensor, kv: torch.Tensor, boxes: torch.Tensor,
                             flags: torch.Tensor, canvas_hw: Tuple[int, int]):
    """Plain version of K1's bounds launch: (hwin i32 [B, N, mw, 2], vwin
    i32 [B, N, mh, 2], extent i32 [B, N, 2]). A window is the first and
    one-past-last nonzero tap of a table row ((0, 0) for a row of zeros); an
    extent (w, h) is one past the last non-empty column and row, the pad
    (min(pw, mw), min(ph, mh)) for an identity placement, and (0, 0) for a
    dropped one."""
    def windows(t):
        nz = t != 0
        idx = torch.arange(t.shape[-1], device=t.device)
        lo = torch.where(nz, idx, t.shape[-1]).amin(-1)
        hi = torch.where(nz, idx + 1, 0).amax(-1)
        live = nz.any(-1)
        rows = torch.arange(1, t.shape[-2] + 1, device=t.device)
        extent = torch.where(live, rows, 0).amax(-1)
        return torch.stack([lo * live, hi], -1).to(torch.int32), extent

    hwin, ext_w = windows(kh)
    vwin, ext_h = windows(kv)
    ident = (flags & FLAG_IDENTITY) > 0
    ext_w = torch.where(ident, min(kh.shape[2], kh.shape[3]), ext_w)
    ext_h = torch.where(ident, min(kv.shape[2], kv.shape[3]), ext_h)
    h_c, w_c = canvas_hw
    x1, y1 = boxes[..., 0].to(torch.int64), boxes[..., 1].to(torch.int64)
    live = ((flags & FLAG_LIVE) > 0) & (x1 >= 0) & (y1 >= 0) & (x1 < w_c) & (y1 < h_c)
    return hwin, vwin, (torch.stack([ext_w, ext_h], -1) * live[..., None]).to(torch.int32)


def k1_tap_windows(kh: torch.Tensor, kv: torch.Tensor, boxes: torch.Tensor,
                   flags: torch.Tensor, canvas_hw: Tuple[int, int]):
    """K1's bounds launch alone, on the card (for the card tests; not
    counted in ``LAUNCHES``). Returns what :func:`k1_tap_windows_reference`
    returns, the extent reduced over the launch's row slices; windows of
    dropped and identity placements are not written (undefined)."""
    if kh.device.type != "cuda":
        raise ValueError(f"k1_tap_windows runs on cuda, not {kh.device}")
    B, N, mw, pw = kh.shape
    mh, ph = kv.shape[2], kv.shape[3]
    S = _kernel_entry("fused_compose_bounds_slices")(mh, mw)
    dev = kh.device
    hwin = torch.empty((B, N, mw, 2), dtype=torch.int32, device=dev)
    vwin = torch.empty((B, N, mh, 2), dtype=torch.int32, device=dev)
    part = torch.empty((B, N, 2, S), dtype=torch.int32, device=dev)
    fn = _kernel_entry("fused_compose_bounds_launch")
    with torch.cuda.device(dev):
        rc = fn(kh.data_ptr(), kv.data_ptr(), boxes.data_ptr(), flags.data_ptr(),
                hwin.data_ptr(), vwin.data_ptr(), part.data_ptr(), B, N,
                int(canvas_hw[0]), int(canvas_hw[1]), ph, pw, mh, mw,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"k1_tap_windows: kernel launch failed with CUDA error {rc}")
    return hwin, vwin, part.amax(-1)


# ------------------ gen-3 geometry and packing (plain torch) ------------------

#: Rec.709 luminance weights of the run statistic
REC709 = (0.2126, 0.7152, 0.0722)
_META_COLS = 10  # ws_x ws_y dx dy same valid in_h in_w out_h out_w
#: u8 scratch (the resampled objects) a K2 launch may hold; the wrapper walks
#: larger batches in chunks
_V3_SCRATCH_BYTES = 1 << 30


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def window_extents(out_hw: Tuple[int, int]) -> Tuple[int, int]:
    """Window size of an object envelope: its extent plus the slack of an
    origin quantised down to (8, 128) multiples."""
    return _round_up(out_hw[0] + 8, 8), _round_up(out_hw[1] + 128, 128)


def _static_window_extents(static_obj_hw, out_max_hw: Tuple[int, int]):
    """Per-object window extents from static asset sizes (each object's
    padded extent capped at the envelope, plus the origin slack)."""
    mh_a, mw_a = out_max_hw
    return tuple(
        window_extents((min(_round_up(max(int(h), 1), 8), mh_a),
                        min(_round_up(max(int(w), 1), 128), mw_a)))
        for h, w in static_obj_hw
    )


def fused_canvas_pad_hw(canvas_hw: Tuple[int, int],
                        out_max_hw: Tuple[int, int]) -> Tuple[int, int]:
    """Padded plane extent the gen-3 programs render into."""
    MH, MW = window_extents((_round_up(out_max_hw[0], 8), _round_up(out_max_hw[1], 128)))
    return max(_round_up(canvas_hw[0], 8), MH), max(_round_up(canvas_hw[1], 128), MW)


class RenderGeometry(NamedTuple):
    """Where a gen-3 render draws, decided once per render program or step
    by :func:`render_geometry`: the tile-aligned output ``envelope``
    (mh_a, mw_a), K2's scratch extent; the padded plane ``pad`` (hp, wp);
    and ``windows``, each object's (h, w) window, which K2 draws in and K3
    restores. With ``per_object`` the windows are each object's own (from
    its bound), else the envelope's window for every object."""

    canvas_hw: Tuple[int, int]
    envelope: Tuple[int, int]
    pad: Tuple[int, int]
    windows: Tuple[Tuple[int, int], ...]
    per_object: bool

    def meta(self, obj_hw, boxes, device=None) -> torch.Tensor:
        """The [B, N, 10] int32 meta of ``boxes`` (:func:`_fused_v3_meta`)
        on ``device`` (default: the boxes'). Columns 0-1 are the windows'
        origins, which the next reuse render restores."""
        return _fused_v3_meta(obj_hw, _long(boxes, device), self.canvas_hw, self.pad,
                              window_extents(self.envelope),
                              self.windows if self.per_object else None)


def render_geometry(canvas_hw: Tuple[int, int], out_hw: Tuple[int, int], n_objects: int,
                    static_obj_hw: Sequence[Tuple[int, int]] | None = None,
                    pipelined: bool = False) -> RenderGeometry:
    """The :class:`RenderGeometry` of a render of ``n_objects`` objects whose
    outputs fit ``out_hw`` (an ``out_max_hw``, or the planar objects' padded
    extent) on a canvas of ``canvas_hw``. Per-object windows apply with
    ``pipelined`` and ``static_obj_hw``, one (h, w) bound per object (the
    JAX package's STATIC_WINDOWS default, compose_pallas.py:3809); a count
    of bounds other than ``n_objects`` raises."""
    if static_obj_hw is not None and len(static_obj_hw) != n_objects:
        raise ValueError(f"static_obj_hw has {len(static_obj_hw)} entries for {n_objects} objects")
    env = _round_up(int(out_hw[0]), 8), _round_up(int(out_hw[1]), 128)
    per_object = bool(pipelined) and static_obj_hw is not None
    windows = (_static_window_extents(static_obj_hw, env) if per_object
               else (window_extents(env),) * n_objects)
    h_c, w_c = (int(v) for v in canvas_hw)
    return RenderGeometry((h_c, w_c), env, fused_canvas_pad_hw((h_c, w_c), env), windows,
                          per_object)


def planarize_objects(objs: torch.Tensor) -> torch.Tensor:
    """[B, N, ph, pw, 4] u8 -> planar [B, N, 4, ph_a, pw_a], zero padded to
    (8, 128) multiples. Run once per objects tensor, not per render."""
    ph, pw = objs.shape[2], objs.shape[3]
    padded = torch.nn.functional.pad(
        objs, (0, 0, 0, _round_up(pw, 128) - pw, 0, _round_up(ph, 8) - ph)
    )
    return padded.permute(0, 1, 4, 2, 3).contiguous()


def pack_rgba_scalar(bg_rgba: Tuple[int, int, int, int]) -> int:
    """(r, g, b, a) -> little-endian packed RGBA as a signed int32 value."""
    r, g, b, a = (int(v) & 255 for v in bg_rgba)
    packed = r | (g << 8) | (b << 16) | (a << 24)
    return packed - (1 << 32) if packed >= 1 << 31 else packed


class GradientRamp(NamedTuple):
    """The gradient background of a padded plane as packed lines:
    ``values`` int32 [wp] (``horizontal``: column x of every row takes
    ``values[x]``) or [hp] (row y takes ``values[y]``), one line shared by
    every canvas; or [B, wp] or [B, hp], canvas b's own line ``values[b]``.
    The lines of a batch run along one axis."""

    values: torch.Tensor
    horizontal: bool


#: a render's background: a packed solid colour or a gradient ramp
Background = Union[int, GradientRamp]


def _packed_ramp(c1, c2, n: int, limit: int, device) -> torch.Tensor:
    """The packed c1 -> c2 ramp of ``n`` steps over ``limit`` pixels, int32
    [..., n] for colours u8 [..., 3]: float64 weights on the host, float32
    lerp, truncating u8 cast, as the reference's fill_gradient, clamped at
    t = 1 past ``limit`` (the plane's pad)."""
    t64 = np.clip(np.arange(n) / max(1, limit - 1), 0.0, 1.0)
    t = torch.from_numpy(t64.astype(np.float32)).to(device)
    w1 = torch.from_numpy((1.0 - t64).astype(np.float32)).to(device)
    c1 = torch.as_tensor(c1, device=device).to(torch.float32)
    c2 = torch.as_tensor(c2, device=device).to(torch.float32)
    ramp = w1[:, None] * c1[..., None, :] + t[:, None] * c2[..., None, :]
    rgb = ramp.to(torch.uint8).to(torch.int32)  # truncation, as the reference
    return rgb[..., 0] | (rgb[..., 1] << 8) | (rgb[..., 2] << 16) | pack_rgba_scalar((0, 0, 0, 255))


def gradient_axis(horizontal) -> bool:
    """The one axis of a batch's gradients: ``horizontal`` is a bool, or a
    sequence of them, one per canvas; gradients on both axes raise
    ValueError (K3's ramp form restores one axis a launch)."""
    if isinstance(horizontal, (bool, np.bool_, int)):
        return bool(horizontal)
    axes = {bool(h) for h in np.asarray(horizontal).reshape(-1).tolist()}
    if len(axes) != 1:
        raise ValueError("the batch's gradients run on both axes (horizontal and vertical); "
                         "a batched gradient render takes one axis a batch")
    return axes.pop()


def gradient_ramp(c1, c2, horizontal, canvas_hw: Tuple[int, int],
                  pad_hw: Tuple[int, int], device) -> GradientRamp:
    """The :class:`GradientRamp` of the c1 -> c2 gradient (u8 RGB triples,
    as ``ops.background.gradient_spec`` gives them: one line; or [B, 3] per
    canvas: a line each, with ``horizontal`` a bool or one per canvas, of
    one axis, see :func:`gradient_axis`) on a canvas padded to ``pad_hw``:
    packed lines along the gradient's axis, the canvas's pixels equal to the
    reference's fill_gradient and the pad at c2."""
    horizontal = gradient_axis(horizontal)
    (H, W), (hp, wp) = canvas_hw, pad_hw
    n, limit = (wp, W) if horizontal else (hp, H)
    return GradientRamp(_packed_ramp(c1, c2, n, limit, device).contiguous(), horizontal)


def _background_plane(bg: Background, B: int, hp: int, wp: int, device) -> torch.Tensor:
    """A fresh padded plane [B, hp, wp] of the background ``bg``."""
    if isinstance(bg, GradientRamp):
        if bg.values.dim() == 2 and bg.values.shape[0] != B:
            raise ValueError(f"the ramp has {bg.values.shape[0]} lines for {B} canvases")
        line = bg.values.to(device)
        line = line[..., None, :] if bg.horizontal else line[..., None]
        return line.expand(B, hp, wp).contiguous()
    return torch.full((B, hp, wp), bg, dtype=torch.int32, device=device)


def packed_to_u8_np(packed_np) -> np.ndarray:
    """Host view of a packed plane as uint8 RGBA [..., H, W, 4] (no copy
    when the array is contiguous)."""
    arr = np.ascontiguousarray(packed_np)
    return arr.view(np.uint8).reshape(*arr.shape, 4)


def packed_to_u8(packed: torch.Tensor) -> torch.Tensor:
    """A packed int32 [..., H, W] tensor as uint8 RGBA [..., H, W, 4]."""
    packed = packed.contiguous()
    return packed.view(torch.uint8).view(*packed.shape, 4)


#: rows of a canvas that one block of the luma kernel's first launch reads
_LUMA_BAND_ROWS = 32


def _check_luma_crop(crop_i32: torch.Tensor) -> None:
    if crop_i32.dtype != torch.int32:
        raise TypeError(f"packed_luma takes a packed int32 crop, got {crop_i32.dtype}")
    if crop_i32.dim() != 3:
        raise ValueError(f"packed_luma takes [B, H, W], got {tuple(crop_i32.shape)}")
    if crop_i32.stride(-1) != 1:
        raise ValueError(f"packed_luma needs a last stride of 1, got strides {crop_i32.stride()}")


def packed_luma_reference(crop_i32: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the luma kernel, on any device: int64 sums
    of each canvas's R, G and B bytes, then ``(wr Sr + wg Sg + wb Sb) / (H W)``
    in float64, rounded to float32, the kernel's operations in its order.
    The division is by a tensor, as the kernel divides (torch's CUDA
    division by a scalar multiplies by its reciprocal)."""
    _check_luma_crop(crop_i32)
    B, H, W = crop_i32.shape
    rgb = crop_i32.view(torch.uint8).unflatten(-1, (W, 4))[..., :3]
    sums = rgb.sum(dim=(1, 2), dtype=torch.int64).to(torch.float64)
    wr, wg, wb = REC709
    lum = wr * sums[:, 0] + wg * sums[:, 1] + wb * sums[:, 2]
    return (lum / torch.full_like(lum, max(1, H * W))).to(torch.float32)


def packed_luma(crop_i32: torch.Tensor) -> torch.Tensor:
    """Mean Rec.709 luminance per canvas of a packed batch [B, H, W], f32.

    ``crop_i32`` is int32 with a last stride of 1 and any batch and row
    strides (a crop of the padded plane). On a CUDA device this launches
    the luma kernel (``csrc/packed_luma.cu``: one read of the crop, exact
    integer channel sums) and raises if the launch fails; on the CPU it
    runs :func:`packed_luma_reference`. Both give the same bits. The JAX
    package reduces float32 luminances; the two agree to float32 rounding
    (~1e-6 relative)."""
    _check_luma_crop(crop_i32)
    if crop_i32.device.type == "cpu":
        return packed_luma_reference(crop_i32)
    if crop_i32.device.type != "cuda":
        raise ValueError(f"packed_luma runs on cuda or cpu, not {crop_i32.device}")
    B, H, W = crop_i32.shape
    dev = crop_i32.device
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    bands = max(1, -(-H // _LUMA_BAND_ROWS))
    if B * bands > _MAX_GRID_X:
        raise ValueError(f"packed_luma: {B} canvases of {H} rows exceed one launch's grid")
    part = torch.empty((B * bands * 3,), dtype=torch.int64, device=dev)
    wr, wg, wb = REC709
    fn = _kernel_entry("packed_luma_launch")
    with _device_guard(dev), launch_range("packed_luma"):
        rc = fn(crop_i32.data_ptr(), part.data_ptr(), out.data_ptr(), B, H, W,
                crop_i32.stride(0), crop_i32.stride(1), bands, float(max(1, H * W)),
                wr, wg, wb, _stream_handle(dev))
    del part  # freed to the caching allocator, in stream order
    if rc != 0:
        raise RuntimeError(f"packed_luma: kernel launch failed with CUDA error {rc}")
    LAUNCHES["packed_luma"] += 1
    return out


def packed_luma_masked(crop_i32: torch.Tensor, canvas_wh) -> torch.Tensor:
    """Masked mean Rec.709 luminance per canvas of a packed batch [B, H, W]
    (port of compose_pallas.py:2121), float32.

    Each canvas averages only its true (W, H) extent of the padded plane
    (``canvas_wh`` [B, 2] as (W, H)): the multi-ratio path's out-of-canvas
    area is garbage by construction. One weighted float32 luminance per
    pixel, as JAX's, masked and reduced with ``torch.sum`` (never a
    matmul-shaped accumulation, which loses bits once a partial sum passes
    2^25)."""
    _, H, W = crop_i32.shape
    dev = crop_i32.device
    px = crop_i32.view(torch.uint8).unflatten(-1, (W, 4))
    wr, wg, wb = REC709
    lum = (wr * px[..., 0].to(torch.float32) + wg * px[..., 1].to(torch.float32)
           + wb * px[..., 2].to(torch.float32))
    wh = torch.as_tensor(canvas_wh, device=dev).to(torch.int32)
    row = torch.arange(H, dtype=torch.int32, device=dev)[None, :, None] < wh[:, 1, None, None]
    col = torch.arange(W, dtype=torch.int32, device=dev)[None, None, :] < wh[:, 0, None, None]
    denom = (wh[:, 0] * wh[:, 1]).to(torch.float32).clamp(min=1.0)
    return torch.sum(lum * (row & col).to(torch.float32), dim=(1, 2)) / denom


def _long(x, device=None) -> torch.Tensor:
    """int64 tensor of ``x`` (a tensor, or a host array copied once)."""
    if torch.is_tensor(x):
        return x.to(device=device or x.device, dtype=torch.int64)
    return torch.tensor(np.asarray(x), dtype=torch.int64, device=device)


def _cap(x: torch.Tensor, cap) -> torch.Tensor:
    """min(x, cap) for an int cap or a tensor of caps."""
    return torch.minimum(x, cap) if torch.is_tensor(cap) else x.clamp(max=cap)


@functools.lru_cache(maxsize=64)
def _device_table(values: Tuple[Tuple[int, ...], ...], dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """A small constant table on the device, uploaded once per (values,
    device) so that a render step makes no host-to-device copy."""
    return torch.tensor(values, dtype=dtype, device=device)


def _window_meta6(boxes: torch.Tensor, canvas_hw, origin_cap=None, same=None):
    """[B, N, 6] int32 (ws_x, ws_y, dx, dy, same, valid): window origins
    quantised down to (8, 128) multiples and capped at ``origin_cap``
    ((max_ws_y, max_ws_x), ints or [1, N] tensors), the object's offset
    inside its window, and ``valid`` = 0 for an origin off the canvas."""
    h_c, w_c = canvas_hw
    x1, y1 = boxes[..., 0], boxes[..., 1]
    drop = (x1 < 0) | (y1 < 0) | (x1 >= w_c) | (y1 >= h_c)
    x1c = x1.clamp(0, w_c)
    y1c = y1.clamp(0, h_c)
    ws_x = torch.div(x1c, 128, rounding_mode="floor") * 128
    ws_y = torch.div(y1c, 8, rounding_mode="floor") * 8
    if origin_cap is not None:
        ws_y = _cap(ws_y, origin_cap[0])
        ws_x = _cap(ws_x, origin_cap[1])
    same_col = torch.zeros_like(x1) if same is None else same.to(x1.dtype)
    return torch.stack(
        [ws_x, ws_y, x1c - ws_x, y1c - ws_y, same_col, (~drop).to(x1.dtype)], dim=-1
    ).to(torch.int32)


def _fused_v3_meta(obj_hw, boxes, canvas_hw, pad_hw, window_hw, static_win=None):
    """[B, N, 10] int32 gen-3 meta: the window meta plus (in_h, in_w, out_h,
    out_w). Target sizes clamp to the window envelope (``cap_w - 128``,
    ``cap_h - 8``; per object with ``static_win``), so an oversized box
    renders a cropped scale, and origins cap at ``hp - cap_h`` /
    ``wp - cap_w`` so each window ends inside the plane. An empty slot
    (object size 0, as a creative with fewer objects than the batch's slots
    pads to) is not valid and its window's origin is (wp, hp), past the
    plane: K2 walks no tile of it and K3 restores nothing there."""
    boxes = _long(boxes)
    obj_hw = _long(obj_hw, boxes.device)
    obj_hw = obj_hw.expand(*boxes.shape[:-1], 2)
    hp, wp = pad_hw
    # per window, the largest box (h, w) and window origin (y, x) it takes;
    # last, an empty slot's window meta, past the plane
    wins = [tuple(window_hw)] if static_win is None else static_win
    rows = [(h - 8, w - 128, hp - h, wp - w, 0, 0) for h, w in wins] + [(wp, hp, 0, 0, 0, 0)]
    table = _device_table(tuple(rows), torch.int32, boxes.device)
    if static_win is None:
        size_h, size_w, origin_y, origin_x = rows[0][:4]
    else:
        size_h, size_w, origin_y, origin_x = table[None, :-1, :4].unbind(-1)
    w = _cap((boxes[..., 2] - boxes[..., 0]).clamp(min=1), size_w)
    h = _cap((boxes[..., 3] - boxes[..., 1]).clamp(min=1), size_h)
    same = (w == obj_hw[..., 1]) & (h == obj_hw[..., 0])
    meta6 = _window_meta6(boxes, canvas_hw, (origin_y, origin_x), same)
    meta6 = torch.where(obj_hw.amin(-1, keepdim=True) <= 0, table[-1], meta6)
    sizes = torch.stack([obj_hw[..., 0], obj_hw[..., 1], h, w], dim=-1)
    return torch.cat([meta6, sizes.to(torch.int32)], dim=-1).contiguous()


# ------------------------------ K2: gen-3 ------------------------------

def _check_v3_args(plane, objs_p, meta, out_max_hw) -> None:
    """Raise on anything K2 does not take: device, dtype, shape, layout."""
    named = dict(plane=plane, objs_p=objs_p, meta=meta)
    dtypes = dict(plane=torch.int32, objs_p=torch.uint8, meta=torch.int32)
    for name, t in named.items():
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if t.device != plane.device:
            raise ValueError(f"{name} is on {t.device}, plane on {plane.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if plane.dim() != 3:
        raise ValueError(f"plane must be [B, hp, wp], got {tuple(plane.shape)}")
    B = plane.shape[0]
    if objs_p.dim() != 5 or objs_p.shape[2] != 4 or objs_p.shape[0] not in (1, B):
        raise ValueError(
            f"objs_p must be planar [1 or B, N, 4, ph, pw], got {tuple(objs_p.shape)}"
        )
    if tuple(meta.shape) != (B, objs_p.shape[1], _META_COLS):
        raise ValueError(f"meta must be [B, N, {_META_COLS}], got {tuple(meta.shape)}")
    if min(out_max_hw) < 1:
        raise ValueError(f"out_max_hw must be positive, got {out_max_hw}")


def fused_v3_reference(plane: torch.Tensor, objs_p: torch.Tensor,
                       meta: torch.Tensor, out_max_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of K2. Builds every table as K2 does: with the
    f32 table code (ops.resize.build_coeffs_traced), or, where the envelope
    ``out_max_hw`` exceeds the objects' padded extent (a render that may
    upscale past the assets), with exact tap arguments on growing axes
    (ops.resize.build_coeffs_v3); resamples each live placement with the
    exact float64 resample, and alpha-overs it in object order; updates
    ``plane`` in place and returns it."""
    _check_v3_args(plane, objs_p, meta, out_max_hw)
    B, hp, wp = plane.shape
    _, N, _, ph, pw = objs_p.shape
    mh, mw = out_max_hw
    m = meta.to(torch.int64)
    in_h, in_w = m[..., 6].clamp(0, ph), m[..., 7].clamp(0, pw)
    out_h, out_w = m[..., 8].clamp(0, mh), m[..., 9].clamp(0, mw)
    tables = build_coeffs_v3 if mh > ph or mw > pw else build_coeffs_traced
    kh = tables(in_w, out_w, pw, mw)  # [B, N, mw, pw]
    kv = tables(in_h, out_h, ph, mh)  # [B, N, mh, ph]
    sizes = torch.stack([in_h, in_w, out_h, out_w], -1).tolist()
    meta_h = m.tolist()
    canvas_u8 = packed_to_u8(plane)  # a view: blends write the plane
    shared = objs_p.shape[0] == 1
    for b in range(B):
        for k in range(N):
            ws_x, ws_y, dx, dy, same, valid = meta_h[b][k][:6]
            if valid <= 0:
                continue
            ih, iw, oh, ow = sizes[b][k]
            obj = objs_p[0 if shared else b, k]  # [4, ph, pw]
            if same > 0:
                res = obj[:, :oh, :ow].permute(1, 2, 0).to(torch.int32)
            else:
                src = premultiply_rgba(obj[:, :ih, :iw].permute(1, 2, 0))
                res = unpremultiply_rgba(
                    resample_fixed(src, kh[b, k, :ow, :iw], kv[b, k, :oh, :ih])
                )
            _blend_window(canvas_u8[b], res, ws_x + dx, ws_y + dy)
    return plane


#: K2's table stage: each placement's output positions, columns then rows,
#: each axis rounded up to the resample's 32-wide tiles; an entry is a
#: growing axis's UPSCALE_TAPS taps, then lo and hi (int32)
_V3_TILE = 32
_V3_ENTRY = UPSCALE_TAPS + 2


def _v3_table_positions(out_max_hw) -> int:
    """Output positions of one placement in K2's table buffer."""
    mh, mw = out_max_hw
    return _round_up(mw, _V3_TILE) + _round_up(mh, _V3_TILE)


def _v3_chunk(B: int, N: int, mh: int, mw: int, mixed: bool) -> int:
    """Canvases a K2 launch takes: its scratch (the resampled objects, and
    in a mixed launch the table buffer) within ``_V3_SCRATCH_BYTES``."""
    per = N * 4 * mh * mw
    if mixed:
        per += N * _v3_table_positions((mh, mw)) * _V3_ENTRY * 4
    return max(1, min(B, _V3_SCRATCH_BYTES // per))


def _check_v3_tables_args(meta, obj_pad_hw, out_max_hw) -> None:
    if not torch.is_tensor(meta) or meta.dtype != torch.int32:
        raise TypeError("meta must be an int32 torch.Tensor")
    if meta.dim() != 3 or meta.shape[2] != _META_COLS:
        raise ValueError(f"meta must be [B, N, {_META_COLS}], got {tuple(meta.shape)}")
    if not meta.is_contiguous():
        raise ValueError("meta must be contiguous")
    if min(obj_pad_hw) < 1 or min(out_max_hw) < 1:
        raise ValueError(f"obj_pad_hw {obj_pad_hw} and out_max_hw {out_max_hw} must be positive")


def _v3_table_axes(meta: torch.Tensor, obj_pad_hw, out_max_hw):
    """K2's table buffer by axis, columns then rows: each axis's sizes
    clamped as K2 clamps them (``n_in``, ``n_out`` int64 [B, N]) and the
    positions its stage writes (bool [B, N, positions]): where a resample
    tile reads them, in a placement that is valid and not a plain copy, on
    an axis that grows, under the output size rounded up to a tile."""
    (ph, pw), (mh, mw) = obj_pad_hw, out_max_hw
    m = meta.to(torch.int64)
    live = (m[..., 5] > 0) & (m[..., 4] <= 0)
    for in_col, out_col, in_max, out_max in ((7, 9, pw, mw), (6, 8, ph, mh)):
        n_in, n_out = m[..., in_col].clamp(0, in_max), m[..., out_col].clamp(0, out_max)
        o = torch.arange(_round_up(out_max, _V3_TILE), device=meta.device)
        tiles_out = (n_out + _V3_TILE - 1) // _V3_TILE * _V3_TILE
        yield n_in, n_out, (live & _grows(n_in, n_out))[..., None] & (o < tiles_out[..., None])


def fused_v3_tables_reference(meta: torch.Tensor, obj_pad_hw: Tuple[int, int],
                              out_max_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain version of K2's table stage: int32 [B, N, P, 8], per placement
    its columns' entries then its rows' (P = :func:`_v3_table_positions`),
    each the window's taps (``ops.resize.upscale_tap_windows``, the
    exact-argument form), lo and hi, where the stage writes them
    (:func:`_v3_table_axes`), and 0 elsewhere."""
    _check_v3_tables_args(meta, obj_pad_hw, out_max_hw)
    parts = []
    for n_in, n_out, written in _v3_table_axes(meta, obj_pad_hw, out_max_hw):
        lo, hi, taps = upscale_tap_windows(n_in, n_out, written.shape[-1])
        entry = torch.cat([taps, lo[..., None].to(torch.int32), hi[..., None].to(torch.int32)], -1)
        parts.append(entry * written[..., None])
    return torch.cat(parts, dim=2)


def fused_v3_tables(meta: torch.Tensor, obj_pad_hw: Tuple[int, int],
                    out_max_hw: Tuple[int, int]) -> torch.Tensor:
    """K2's table stage alone, as a mixed :func:`fused_v3` launch runs it
    ahead of the resample: :func:`fused_v3_tables_reference`'s buffer (its
    unwritten entries 0). On a CUDA device it launches the stage on the
    current stream (counted in ``LAUNCHES["fused_v3_tables"]``) and raises
    if the launch fails; on the CPU it runs the plain version."""
    _check_v3_tables_args(meta, obj_pad_hw, out_max_hw)
    if meta.device.type == "cpu":
        return fused_v3_tables_reference(meta, obj_pad_hw, out_max_hw)
    if meta.device.type != "cuda":
        raise ValueError(f"fused_v3_tables runs on cuda or cpu, not {meta.device}")
    B, N, _ = meta.shape
    ph, pw = (int(v) for v in obj_pad_hw)
    mh, mw = (int(v) for v in out_max_hw)
    dev = meta.device
    tables = torch.zeros((B, N, _v3_table_positions((mh, mw)), _V3_ENTRY), dtype=torch.int32,
                         device=dev)
    if B * N == 0:
        return tables
    with torch.cuda.device(dev):
        rc = _kernel_entry("fused_v3_tables_launch")(
            meta.data_ptr(), tables.data_ptr(), B, N, ph, pw, mh, mw,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_v3_tables: kernel launch failed with CUDA error {rc}")
    LAUNCHES["fused_v3_tables"] += 1
    return tables


def _v3_live_tiles(meta: torch.Tensor, out_max_hw: Tuple[int, int]) -> torch.Tensor:
    """Live 32x32 tiles of each placement of a K2 launch, int64 [B, N]: the
    tiles of its output extent (``out_h``, ``out_w`` clamped to the
    envelope ``out_max_hw``), 0 where it is not valid: the tiles K2's walk
    hands out (``csrc/live_tiles.cuh``), which are the blocks of a grid
    over the envelope that would pass the kernels' early exits."""
    mh, mw = out_max_hw
    m = meta.to(torch.int64)
    tiles = ((m[..., 8].clamp(0, mh) + _V3_TILE - 1) // _V3_TILE
             * ((m[..., 9].clamp(0, mw) + _V3_TILE - 1) // _V3_TILE))
    return torch.where(m[..., 5] > 0, tiles, torch.zeros_like(tiles))


class _V3Grid(NamedTuple):
    """The launches of one K2 chunk (:func:`_v3_grid`), for its resample
    and its blend: the launches (more than one where the chunk's placements
    pass the walk's cap), the most placements a launch walks (the cap),
    their blocks in all, the resident blocks an SM, and the first launch's
    dynamic shared memory (bytes)."""

    resample_launches: int
    resample_cap: int
    resample_blocks: int
    resample_resident: int
    resample_smem: int
    blend_launches: int
    blend_cap: int
    blend_blocks: int
    blend_resident: int
    blend_smem: int


def _v3_grid(batch: int, n_objects: int, obj_pad_hw: Tuple[int, int],
             out_max_hw: Tuple[int, int], device) -> _V3Grid:
    """The launches :func:`fused_v3` makes for one chunk of ``batch``
    canvases on a CUDA ``device``, as ``csrc/fused_v3.cu`` makes them:
    persistent grids (the SMs times the resident blocks an SM, or fewer)
    over the live tiles of at most as many placements as the walk's prefix
    of 4 bytes a placement fits beside each kernel's shared memory without
    lowering its resident blocks. For the smoke run's and the card tests'
    block counts."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"_v3_grid needs a CUDA device, not {dev}")
    out = (ctypes.c_longlong * 10)()
    with torch.cuda.device(dev):
        rc = _kernel_entry("fused_v3_grid")(int(batch), int(n_objects),
                                            *(int(v) for v in obj_pad_hw),
                                            *(int(v) for v in out_max_hw), out)
    if rc != 0:
        raise RuntimeError(f"fused_v3_grid: CUDA error {rc}")
    return _V3Grid(*(int(v) for v in out))


def fused_v3_h_tally(device=None) -> Tuple[int, int]:
    """K2's mixed-instance resample tiles on a CUDA ``device`` (the current
    one by default) since the kernels' library was loaded: (tiles whose H
    pass took the column form, all tiles it resampled). Synchronises the
    device first; for the smoke run and the card tests, not a timed step."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"fused_v3_h_tally needs a CUDA device, not {dev}")
    out = (ctypes.c_longlong * 2)()
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        rc = _kernel_entry("fused_v3_h_tally")(out)
    if rc != 0:
        raise RuntimeError(f"fused_v3_h_tally: CUDA error {rc}")
    return int(out[0]), int(out[1])


_V3_CLAIMS = {}  # (device index, stream handle): K2's resample claim counter


def _v3_claims(dev: torch.device, stream: int) -> torch.Tensor:
    """K2's resample claim counter for ``stream`` of ``dev``: two int32,
    zero between launches (each launch's last block zeroes them), kept
    per stream so that launches running at one time never share one, and
    allocated at the stream's first K2 launch. A stream that is being
    captured into a CUDA graph gets a new counter each launch, from the
    graph's memory, whose zeroing the graph records."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(2, dtype=torch.int32, device=dev)
    key = (dev.index, stream)
    claims = _V3_CLAIMS.get(key)
    if claims is None:
        claims = _V3_CLAIMS.setdefault(key, torch.zeros(2, dtype=torch.int32, device=dev))
    return claims


def fused_v3(plane: torch.Tensor, objs_p: torch.Tensor, meta: torch.Tensor,
             out_max_hw: Tuple[int, int]) -> torch.Tensor:
    """Resample every live placement with tables built from its sizes and
    alpha-over it into its window of the packed plane, in object order.
    Updates ``plane`` IN PLACE and returns it.

    plane  i32 [B, hp, wp]            packed RGBA
    objs_p u8  [Bo, N, 4, ph, pw]     planar objects, Bo == 1 (shared) or B
    meta   i32 [B, N, 10]             from :func:`_fused_v3_meta`
    out_max_hw (mh, mw)               the output envelope (scratch extents)

    On a CUDA device this launches K2 (``csrc/fused_v3.cu``) on the current
    stream, over chunks of canvases that keep its scratch under
    ``_V3_SCRATCH_BYTES``, and raises if a launch fails; on the CPU it runs
    :func:`fused_v3_reference`. Each chunk's resample and blend walk only
    its live tiles (the resample's launches counted in
    ``LAUNCHES["fused_v3_walks"]``).

    Upscale accuracy depends on the envelope, not on the box: where
    ``out_max_hw`` exceeds the objects' padded extent (mh > ph or mw > pw)
    a growing axis's tables take exact tap arguments (within 2 units of
    2^22 of Pillow's), built once per placement by K2's table stage
    (:func:`fused_v3_tables`, counted in ``LAUNCHES["fused_v3_tables"]``
    once per chunk) ahead of the resample; otherwise every table takes
    the f32 centre, which at
    large upscales within the pad moves pixels by up to 3. So one upscaled
    box may render with other bytes under another caller's envelope.
    """
    if plane.device.type == "cpu":
        return fused_v3_reference(plane, objs_p, meta, out_max_hw)
    _check_v3_args(plane, objs_p, meta, out_max_hw)
    if plane.device.type != "cuda":
        raise ValueError(f"fused_v3 runs on cuda or cpu, not {plane.device}")
    B, hp, wp = plane.shape
    Bo, N, _, ph, pw = objs_p.shape
    mh, mw = (int(v) for v in out_max_hw)
    if min(B, N, hp, wp, ph, pw) == 0:
        return plane
    mixed = mh > ph or mw > pw  # the launch builds its growing axes' tables first
    chunk = _v3_chunk(B, N, mh, mw, mixed)
    fn = _kernel_entry("fused_v3_launch")
    dev = plane.device
    res = torch.empty((chunk, N, mh, mw, 4), dtype=torch.uint8, device=dev)
    tables = (torch.empty((chunk, N, _v3_table_positions((mh, mw)), _V3_ENTRY),
                          dtype=torch.int32, device=dev) if mixed else None)
    walks = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        claims = _v3_claims(dev, stream)
        for b0 in range(0, B, chunk):
            nb = min(chunk, B - b0)
            rc = fn(
                plane[b0].data_ptr(), objs_p[0 if Bo == 1 else b0].data_ptr(),
                meta[b0].data_ptr(), res.data_ptr(), tables.data_ptr() if mixed else None,
                claims.data_ptr(), nb, Bo, N, hp, wp, ph, pw, mh, mw, stream,
                ctypes.byref(walks),
            )
            if rc != 0:
                raise RuntimeError(f"fused_v3: kernel launch failed with CUDA error {rc}")
            LAUNCHES["fused_v3_chunks"] += 1
            LAUNCHES["fused_v3_own_objects"] += Bo > 1
            LAUNCHES["fused_v3_tables"] += mixed
            LAUNCHES["fused_v3_walks"] += walks.value
    LAUNCHES["fused_v3"] += 1
    return plane


# --------------------------- K3: window restore ---------------------------

def _check_restore_args(plane, origins, n_extents: int) -> None:
    for name, t in dict(plane=plane, origins=origins).items():
        if not torch.is_tensor(t) or t.dtype != torch.int32:
            raise TypeError(f"{name} must be an int32 torch.Tensor")
        if t.device != plane.device:
            raise ValueError(f"{name} is on {t.device}, plane on {plane.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if plane.dim() != 3:
        raise ValueError(f"plane must be [B, hp, wp], got {tuple(plane.shape)}")
    if origins.dim() != 3 or origins.shape[0] != plane.shape[0] or origins.shape[2] != 2:
        raise ValueError(f"origins must be [B, N, 2], got {tuple(origins.shape)}")
    if n_extents != origins.shape[1]:
        raise ValueError(f"{n_extents} window extents for {origins.shape[1]} objects")


def _restore_pairs(extents) -> Tuple[Tuple[int, int], ...]:
    """The (h, w) window extents as a tuple of int pairs; raises on anything
    else."""
    if any(len(e) != 2 for e in extents):
        raise ValueError(f"extents must be N (h, w) pairs, got {extents}")
    return tuple((int(h), int(w)) for h, w in extents)


@functools.lru_cache(maxsize=64)
def _restore_table(extents, device: torch.device) -> Tuple[torch.Tensor, int]:
    """(extents i32 [N, 2] on ``device``, the largest window height) of one
    extents sequence, built once per (sequence, device) so that a render
    step makes no host-to-device copy and no host loop."""
    pairs = _restore_pairs(extents)
    table = torch.tensor(pairs, dtype=torch.int32, device=device).reshape(len(pairs), 2)
    return table, max((h for h, _ in pairs), default=0)


def _check_ramp(plane: torch.Tensor, ramp: GradientRamp) -> None:
    """Raise unless the ramp is one line of the plane's axis, or a line per
    canvas."""
    v = ramp.values
    B, n = plane.shape[0], plane.shape[2] if ramp.horizontal else plane.shape[1]
    if not torch.is_tensor(v) or v.dtype != torch.int32 or v.device != plane.device:
        raise TypeError(f"the ramp must be an int32 tensor on {plane.device}")
    if tuple(v.shape) not in ((n,), (B, n)) or not v.is_contiguous():
        raise ValueError(f"the ramp must be contiguous [{n}] or [{B}, {n}] (a line per "
                         f"canvas), got {tuple(v.shape)}")


def restore_windows_reference(plane: torch.Tensor, origins: torch.Tensor,
                              extents: Sequence[Tuple[int, int]],
                              bg: Background) -> torch.Tensor:
    """Plain PyTorch version of K3: fill each window (origin (x, y) of
    placement (b, k), extent (h, w) of object k) with the background ``bg``
    (a packed colour, or the ramp's values at the window's columns or
    rows: the shared line's, or canvas b's own), cut at the plane's edge.
    Updates ``plane`` in place and returns it."""
    _check_restore_args(plane, origins, len(extents))
    extents = _restore_pairs(extents)
    ramp = isinstance(bg, GradientRamp)
    if ramp:
        _check_ramp(plane, bg)
        lines = bg.values.expand(plane.shape[0], -1)  # canvas b's line, shared or its own
    for b, row in enumerate(origins.tolist()):
        for k, (x, y) in enumerate(row):
            h, w = extents[k]
            ys = slice(max(y, 0), max(y + h, 0))
            xs = slice(max(x, 0), max(x + w, 0))
            if not ramp:
                plane[b, ys, xs] = bg
            elif bg.horizontal:
                plane[b, ys, xs] = lines[b, xs][None, :]
            else:
                plane[b, ys, xs] = lines[b, ys][:, None]
    return plane


def restore_windows(plane: torch.Tensor, origins: torch.Tensor,
                    extents: Sequence[Tuple[int, int]], bg: Background) -> torch.Tensor:
    """Fill every window of the previous render with the background: a
    packed solid colour, or a :class:`GradientRamp` of the plane. Updates
    ``plane`` IN PLACE and returns it.

    plane i32 [B, hp, wp]; origins i32 [B, N, 2] (x, y); extents: N host
    (h, w) pairs, the window extent of object k (a tuple of pairs, as the
    render programs pass, is uploaded once and then found in a cache). A
    ramp's values are one line or a line per canvas ([B, n]). On a CUDA
    device this launches K3 (``csrc/restore_windows.cu``; its solid or its
    ramp form, a ramp with a line per canvas counted in
    ``LAUNCHES["restore_windows_lines"]`` too) and raises if the launch
    fails; on the CPU it runs :func:`restore_windows_reference`.
    """
    if plane.device.type == "cpu":
        return restore_windows_reference(plane, origins, extents, bg)
    _check_restore_args(plane, origins, len(extents))
    if plane.device.type != "cuda":
        raise ValueError(f"restore_windows runs on cuda or cpu, not {plane.device}")
    B, hp, wp = plane.shape
    N = origins.shape[1]
    if min(B, N, hp, wp) == 0:
        return plane
    dev = plane.device
    try:
        ext_d, max_wh = _restore_table(extents, dev)
    except TypeError:  # an unhashable sequence (a list): its tuple
        ext_d, max_wh = _restore_table(_restore_pairs(extents), dev)
    lines = False
    with _device_guard(dev):
        if isinstance(bg, GradientRamp):
            _check_ramp(plane, bg)
            lines = bg.values.dim() == 2
            rc = _kernel_entry("restore_windows_ramp_launch")(
                plane.data_ptr(), origins.data_ptr(), ext_d.data_ptr(), bg.values.data_ptr(),
                B, N, hp, wp, max_wh, int(bg.horizontal), bg.values.shape[-1] if lines else 0,
                _stream_handle(dev))
        else:
            rc = _kernel_entry("restore_windows_launch")(
                plane.data_ptr(), origins.data_ptr(), ext_d.data_ptr(),
                B, N, hp, wp, max_wh, int(bg), _stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"restore_windows: kernel launch failed with CUDA error {rc} "
                           "(past ~14,500 windows a canvas's do not fit shared memory)")
    LAUNCHES["restore_windows"] += 1
    LAUNCHES["restore_windows_lines"] += lines
    return plane


# ------------------------------ the programs ------------------------------

def render_fused_v3_step(geometry: RenderGeometry, objs_p: torch.Tensor, obj_hw, boxes,
                         bg: Background, prev=None):
    """One batched gen-3 render in ``geometry``, the code that every render
    program and ``parallel.sweep``'s render step run: the meta of
    ``boxes``, then K2 on a fresh plane of the background ``bg`` (a packed
    solid colour or a :class:`GradientRamp`); or, with ``prev`` = (plane,
    meta) of the previous render in this geometry, K3 restores the windows
    that meta drew (origins its columns 0-1, extents ``geometry.windows``)
    from ``bg`` and K2 composes on that plane IN PLACE. Returns (plane,
    meta), the pair the next reuse render takes as ``prev``."""
    if not isinstance(bg, (int, np.integer, GradientRamp)):
        raise TypeError(f"bg must be a packed colour or a GradientRamp, got {type(bg).__name__}")
    if prev is not None and tuple(prev[0].shape[1:]) != geometry.pad:
        raise ValueError(f"prev plane {tuple(prev[0].shape[1:])} != expected {geometry.pad}")
    with span("itx.render.meta"):
        meta = geometry.meta(obj_hw, boxes, objs_p.device)
        origins = None if prev is None else prev[1][..., :2].contiguous()
    if prev is None:
        plane = _background_plane(bg, meta.shape[0], *geometry.pad, objs_p.device)
        return fused_v3(plane, objs_p, meta, geometry.envelope), meta
    plane = prev[0]
    with span("itx.render.restore", plane.device):
        restore_windows(plane, origins, geometry.windows, bg)
    with span("itx.render.compose", plane.device):
        return fused_v3(plane, objs_p, meta, geometry.envelope), meta


def composite_batch_fused_v3(
    canvases,
    objs: torch.Tensor,
    obj_hw,
    boxes,
    out_max_hw: Tuple[int, int] | None = None,
    packed_out: bool = False,
    pipelined: bool = False,
    bg_rgba: Tuple[int, int, int, int] | None = None,
    canvas_hw: Tuple[int, int] | None = None,
    padded_out: bool = False,
    static_obj_hw: Sequence[Tuple[int, int]] | None = None,
) -> torch.Tensor:
    """Gen-3 compose of a batch (port of compose_pallas.py:3675).

    canvases: u8 [B, H, W, 4], packed i32 [B, H, W], or None with
    ``bg_rgba`` and ``canvas_hw`` (a solid plane made on the device; the
    batch then comes from ``boxes``). objs: u8 [Bo, N, ph, pw, 4] or planar
    [Bo, N, 4, ph_a, pw_a], Bo == 1 (shared by all canvases) or B. Returns
    u8 [B, H, W, 4], or with ``packed_out`` the packed i32 [B, H, W] (the
    whole padded plane with ``padded_out``). Runs K2 on a CUDA device.
    """
    if canvases is None:
        if bg_rgba is None or canvas_hw is None:
            raise ValueError("canvases=None requires bg_rgba and canvas_hw")
        h_c, w_c = canvas_hw
    else:
        h_c, w_c = canvases.shape[1], canvases.shape[2]
    if padded_out and not packed_out:
        raise ValueError("padded_out requires packed_out")
    objs_p = objs if objs.shape[4] != 4 else planarize_objects(objs)
    geo = render_geometry((h_c, w_c), objs_p.shape[3:] if out_max_hw is None else out_max_hw,
                          objs_p.shape[1], static_obj_hw, pipelined)
    if canvases is None:
        plane, _ = render_fused_v3_step(geo, objs_p, obj_hw, boxes, pack_rgba_scalar(bg_rgba))
    else:
        meta = geo.meta(obj_hw, boxes, objs_p.device)
        B = meta.shape[0]
        plane = torch.zeros((B, *geo.pad), dtype=torch.int32, device=objs_p.device)
        packed = canvases if canvases.dtype == torch.int32 else (
            canvases.contiguous().view(torch.int32).reshape(B, h_c, w_c)
        )
        plane[:, :h_c, :w_c] = packed
        fused_v3(plane, objs_p, meta, geo.envelope)
    out = plane if padded_out else plane[:, :h_c, :w_c]
    return out if packed_out else packed_to_u8(out)


def render_fused_v3_program(
    objs_p: torch.Tensor,
    obj_hw,
    boxes,
    canvas_hw: Tuple[int, int],
    bg: Background,
    out_max_hw: Tuple[int, int] | None = None,
    pipelined: bool = False,
    static_obj_hw: Sequence[Tuple[int, int]] | None = None,
) -> torch.Tensor:
    """Batch render on one background for every canvas (port of
    compose_pallas.py:3763): a plane of ``bg`` (a packed solid colour, or a
    :class:`GradientRamp` of the padded plane) made on the device, then K2.
    Returns the padded packed plane [B, hp, wp]; crop with
    ``packed_to_u8(out)[:, :H, :W]``. ``objs_p`` is planar and may be
    shared ([1, N, ...]); the batch comes from ``boxes``. ``static_obj_hw``
    (with ``pipelined``) bounds each object's output size: a larger box
    renders at the size its window clamps it to."""
    geo = render_geometry(canvas_hw, objs_p.shape[3:] if out_max_hw is None else out_max_hw,
                          objs_p.shape[1], static_obj_hw, pipelined)
    return render_fused_v3_step(geo, objs_p, obj_hw, boxes, bg)[0]


def render_solid_fused_v3_program(
    objs_p: torch.Tensor,
    obj_hw,
    boxes,
    canvas_hw: Tuple[int, int],
    bg_packed: int,
    out_max_hw: Tuple[int, int] | None = None,
    pipelined: bool = False,
    static_obj_hw: Sequence[Tuple[int, int]] | None = None,
) -> torch.Tensor:
    """Solid-background batch render: :func:`render_fused_v3_program` on a
    plane filled with ``bg_packed``."""
    return render_fused_v3_program(objs_p, obj_hw, boxes, canvas_hw, int(bg_packed),
                                   out_max_hw, pipelined, static_obj_hw)


def render_fused_v3_reuse_program(
    prev_v: torch.Tensor,
    prev_boxes,
    objs_p: torch.Tensor,
    obj_hw,
    boxes,
    canvas_hw: Tuple[int, int],
    bg: Background,
    out_max_hw: Tuple[int, int] | None = None,
    static_obj_hw: Sequence[Tuple[int, int]] | None = None,
    pipelined: bool = False,
) -> torch.Tensor:
    """Framebuffer-reuse render (port of compose_pallas.py:4011): restore
    the windows the previous render (``prev_boxes``) drew on ``prev_v``
    with K3, from the background ``bg`` (a packed solid colour or a
    :class:`GradientRamp`; anything else raises TypeError), then compose
    ``boxes`` with K2.

    Where JAX donates ``prev_v``, the port restores and composes IN PLACE
    on the same tensor and returns it. ``prev_v`` must come from a render
    with the same ``bg``, canvas, envelope, objects and window settings:
    the restore fills the windows that render drew, each object's own with
    ``pipelined`` and ``static_obj_hw``, else the envelope's. (JAX restores
    per-object windows wherever ``static_obj_hw`` is given and B >= 2, also
    after a render that drew the envelope's.) ``static_obj_hw`` is a
    per-object bound of the output size, which sizes both K2's window and
    the restore window: a box larger than its bound renders at the size the
    window clamps it to (another scale than the box's), so where boxes
    upscale, pass bounds of the output sizes, not of the assets.
    """
    geo = render_geometry(canvas_hw, objs_p.shape[3:] if out_max_hw is None else out_max_hw,
                          objs_p.shape[1], static_obj_hw, pipelined)
    prev_meta = geo.meta(obj_hw, prev_boxes, prev_v.device)
    return render_fused_v3_step(geo, objs_p, obj_hw, boxes, bg, (prev_v, prev_meta))[0]


def render_solid_fused_v3_reuse_program(
    prev_v: torch.Tensor,
    prev_boxes,
    objs_p: torch.Tensor,
    obj_hw,
    boxes,
    canvas_hw: Tuple[int, int],
    bg_packed: int,
    out_max_hw: Tuple[int, int] | None = None,
    static_obj_hw: Sequence[Tuple[int, int]] | None = None,
    pipelined: bool = False,
) -> torch.Tensor:
    """:func:`render_fused_v3_reuse_program` on a solid background
    ``bg_packed``."""
    return render_fused_v3_reuse_program(prev_v, prev_boxes, objs_p, obj_hw, boxes, canvas_hw,
                                         int(bg_packed), out_max_hw, static_obj_hw, pipelined)


def render_gradient_fused_v3_program(
    objs_p: torch.Tensor,
    obj_hw,
    boxes,
    canvas_hw: Tuple[int, int],
    c1,
    c2,
    horizontal: bool,
    out_max_hw: Tuple[int, int] | None = None,
    static_obj_hw: Sequence[Tuple[int, int]] | None = None,
) -> torch.Tensor:
    """Gradient-background batch render (port of compose_pallas.py:4088):
    the linear c1 -> c2 ramp per canvas (c1, c2 u8 [B, 3]; float64 weights
    on the host, float32 lerp, truncating u8 cast, as the reference's
    fill_gradient) made as the packed plane, clamped at t = 1 in the pad,
    then K2. Returns the padded packed plane [B, hp, wp]."""
    geo = render_geometry(canvas_hw, objs_p.shape[3:] if out_max_hw is None else out_max_hw,
                          objs_p.shape[1], static_obj_hw)
    ramp = gradient_ramp(c1, c2, horizontal, canvas_hw, geo.pad, objs_p.device)
    return render_fused_v3_step(geo, objs_p, obj_hw, boxes, ramp)[0]


# ------------------ K4: the two-program hybrid compose ------------------

def _legacy_canvas_pad_hw(canvas_hw: Tuple[int, int],
                          window_hw: Tuple[int, int]) -> Tuple[int, int]:
    """Padded plane extent of the UNCLAMPED window blends (JAX :774): the
    canvas pads by a full window on the bottom/right, so no window origin
    needs a cap."""
    h_c, w_c = canvas_hw
    MH, MW = window_hw
    return _round_up(h_c + MH, 8), _round_up(w_c + MW, 128)


def _unpack_rgba_u32(v_i32: torch.Tensor):
    """Packed little-endian RGBA (int32 bits) -> (r, g, b, a) int32. The
    mask after each shift drops the sign of pixels with alpha >= 128."""
    return tuple((v_i32 >> s) & 255 for s in (0, 8, 16, 24))


def _pack_rgba_u32(r, g, b, a) -> torch.Tensor:
    """(r, g, b, a) of 0..255 -> packed little-endian RGBA int32, through
    the bytes (``a << 24`` would overflow int32 for alpha >= 128)."""
    return torch.stack([r, g, b, a], dim=-1).to(torch.uint8).view(torch.int32)[..., 0]


def _alpha_over_packed(dst_v: torch.Tensor, src_v: torch.Tensor) -> torch.Tensor:
    """Pillow-exact alpha-over on packed pixels (int32 bit patterns)."""
    out = alpha_over_u8(torch.stack(_unpack_rgba_u32(dst_v), dim=-1),
                        torch.stack(_unpack_rgba_u32(src_v), dim=-1))
    return _pack_rgba_u32(*out.unbind(-1))


def _clamped_pad_hw(canvas_hw: Tuple[int, int],
                    window_hw: Tuple[int, int]) -> Tuple[int, int]:
    """Padded plane extent of the CLAMPED window blends: (8, 128) multiples
    and at least one window; origins cap at ``(hp - MH, wp - MW)``."""
    return (max(_round_up(canvas_hw[0], 8), window_hw[0]),
            max(_round_up(canvas_hw[1], 128), window_hw[1]))


def _blend_envelope(objs: torch.Tensor, out_max_hw) -> Tuple[int, int]:
    """(mh_a, mw_a): ``out_max_hw`` (default: the NHWC objects' pad) rounded
    up to (8, 128) multiples."""
    if out_max_hw is None:
        out_max_hw = (objs.shape[2], objs.shape[3])
    return _round_up(out_max_hw[0], 8), _round_up(out_max_hw[1], 128)


def _packed_plane(canvases: torch.Tensor, pad_hw: Tuple[int, int]) -> torch.Tensor:
    """A new packed plane [B, hp, wp] holding the u8 canvases [B, H, W, 4]
    at its top-left, zero elsewhere."""
    B, h_c, w_c = canvases.shape[:3]
    plane = torch.zeros((B, *pad_hw), dtype=torch.int32, device=canvases.device)
    plane[:, :h_c, :w_c] = canvases.contiguous().view(torch.int32)[..., 0]
    return plane


def _box_sizes(obj_hw, boxes, device):
    """(in_h, in_w, out_h, out_w) int64 [B, N] of each placement: its object's
    size and its box's, floored at 1 px."""
    boxes = _long(boxes, device)
    obj_hw = _long(obj_hw, device)
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=1)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=1)
    return obj_hw[..., 0], obj_hw[..., 1], h, w


def _shifted_copy(objs: torch.Tensor, origin_yx, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Pillow's identity copy at per-placement origins: u8 [B, N, out_h,
    out_w, 4] with ``out[b, k, r, c] = objs[b, k, r - y, c - x]`` where that
    lies inside the object tensor, 0 elsewhere. ``objs`` [Bo, N, h, w, 4]
    (Bo == 1 broadcasts); ``origin_yx`` = (y, x), int64 [B, N]."""
    h, w = objs.shape[2], objs.shape[3]
    dev = objs.device
    y, x = origin_yx
    objz = torch.nn.functional.pad(objs, (0, 0, 0, 1, 0, 1))  # zero row h, zero column w
    r = torch.arange(out_hw[0], device=dev) - y[..., None]
    c = torch.arange(out_hw[1], device=dev) - x[..., None]
    r = torch.where((r >= 0) & (r < h), r, h)
    c = torch.where((c >= 0) & (c < w), c, w)
    rows = torch.take_along_dim(objz, r[..., :, None, None], dim=2)
    return torch.take_along_dim(rows, c[..., None, :, None], dim=3)


def _hybrid_producer_impl(canvases, objs, obj_hw, boxes, out_max_hw, method, clamp):
    """Resize every object and build the packed plane and meta for K4 (port
    of JAX :2283), on the canvases' device with no host round trip.

    ``clamp=True`` caps window origins at ``(hp - MH, wp - MW)`` and pads
    the plane only to (8, 128) multiples and one window; ``clamp=False``
    pads it by a full window (:func:`_legacy_canvas_pad_hw`) and leaves the
    origins uncapped. Returns (canvas_v i32 [B, hp, wp], a new plane holding
    the canvases; src_v i32 [B, N, mh_a, mw_a], each object resized to its
    box and cut at the envelope; meta i32 [B, N, 6])."""
    h_c, w_c = canvases.shape[1:3]
    mh_a, mw_a = out_max_hw
    MH, MW = window_extents((mh_a, mw_a))
    if clamp:
        hp, wp = _clamped_pad_hw((h_c, w_c), (MH, MW))
    else:
        hp, wp = _legacy_canvas_pad_hw((h_c, w_c), (MH, MW))
    boxes = _long(boxes, canvases.device)
    in_h, in_w, h, w = _box_sizes(obj_hw, boxes, canvases.device)
    resized = resize_u8(objs, (in_h, in_w), (h, w), (mh_a, mw_a), method)
    src_v = resized.view(torch.int32)[..., 0]
    meta = _window_meta6(boxes, (h_c, w_c), origin_cap=(hp - MH, wp - MW) if clamp else None)
    return _packed_plane(canvases, (hp, wp)), src_v, meta


def _hybrid_producer_clamped(canvases, objs, obj_hw, boxes, out_max_hw, method):
    return _hybrid_producer_impl(canvases, objs, obj_hw, boxes, out_max_hw, method,
                                 clamp=True)


def _hybrid_producer(canvases, objs, obj_hw, boxes, out_max_hw, method):
    return _hybrid_producer_impl(canvases, objs, obj_hw, boxes, out_max_hw, method,
                                 clamp=False)


def window_extents_rowbaked(src_hw: Tuple[int, int]) -> Tuple[int, int]:
    """Window of a row-baked source [MH, mw_a]: it already spans the window
    height (JAX :2194)."""
    mh_src, mw_a = src_hw
    return mh_src, _round_up(mw_a + 128, 128)


def _hybrid_producer_rowbaked(canvases, objs, obj_hw, boxes, out_max_hw, method):
    """Producer of row 11 (port of JAX :2236): the clamped plane and meta,
    and each object resampled directly to its row offset ``dy`` inside its
    window (``dy`` baked into the V tables), so the sources are
    [B, N, MH, mw_a]. Pillow's identity copy is row-shifted the same way,
    as JAX slices it out of a top-padded buffer (which never clamps)."""
    h_c, w_c = canvases.shape[1:3]
    mh_a, mw_a = out_max_hw
    MH, MW = window_extents((mh_a, mw_a))
    hp, wp = _clamped_pad_hw((h_c, w_c), (MH, MW))
    dev = canvases.device
    boxes = _long(boxes, dev)
    meta = _window_meta6(boxes, (h_c, w_c), origin_cap=(hp - MH, wp - MW))
    dy = meta[..., 3].to(torch.int64)
    zero = torch.zeros_like(dy)
    in_h, in_w, h, w = _box_sizes(obj_hw, boxes, dev)
    resized = resize_f32_shifted(objs, (in_h, in_w), (h, w), (dy, zero), (MH, mw_a), method)
    crop = objs[:, :, :min(objs.shape[2], MH), :min(objs.shape[3], mw_a)]
    ident = _shifted_copy(crop, (dy, zero), (MH, mw_a))
    same = (w == in_w) & (h == in_h)
    src = torch.where(same[..., None, None, None], ident, resized.to(torch.uint8))
    return _packed_plane(canvases, (hp, wp)), src.contiguous().view(torch.int32)[..., 0], meta


def _hybrid_producer_aligned(canvases, objs, obj_hw, boxes, out_max_hw, method):
    """Producer of row 4 (port of JAX :1396): the legacy plane (padded by a
    full window), uncapped meta, and each object resampled directly to its
    window position ``(dy, dx)`` (both baked into the tables), so the sources
    are whole windows [B, N, MH, MW].

    Pillow's identity copy is JAX's ``dynamic_update_slice`` of the padded
    object into the window, which clamps its start to ``(MH - ph, MW - pw)``:
    with the default envelope the clamp never moves it (``MH >= ph + 8``,
    ``MW >= pw + 128``); with a smaller ``out_max_hw`` it shifts the copy up
    or left, and the port does the same. An object pad larger than the
    window raises, as JAX does."""
    h_c, w_c = canvases.shape[1:3]
    ph, pw = objs.shape[2], objs.shape[3]
    MH, MW = window_extents(out_max_hw)
    if ph > MH or pw > MW:
        raise ValueError(f"object pad {(ph, pw)} exceeds the window {(MH, MW)}: the "
                         "identity copy does not fit (JAX's dynamic_update_slice raises)")
    dev = canvases.device
    boxes = _long(boxes, dev)
    meta = _window_meta6(boxes, (h_c, w_c))
    dx, dy = meta[..., 2].to(torch.int64), meta[..., 3].to(torch.int64)
    in_h, in_w, h, w = _box_sizes(obj_hw, boxes, dev)
    resized = resize_f32_shifted(objs, (in_h, in_w), (h, w), (dy, dx), (MH, MW), method)
    ident = _shifted_copy(objs, (dy.clamp(max=MH - ph), dx.clamp(max=MW - pw)), (MH, MW))
    same = (w == in_w) & (h == in_h)
    src = torch.where(same[..., None, None, None], ident, resized.to(torch.uint8))
    plane = _packed_plane(canvases, _legacy_canvas_pad_hw((h_c, w_c), (MH, MW)))
    return plane, src.contiguous().view(torch.int32)[..., 0], meta


def _hybrid_producer_planar(canvases, objs, obj_hw, boxes, out_max_hw, method):
    """Producer of row 2 (``composite_batch_hybrid``, JAX :1150-1172): the
    canvases as a planar u8 plane [B, 4, hp, wp] padded by a full window,
    each object resized to its box as planar u8 [B, N, 4, mh_a, mw_a], and
    the uncapped meta."""
    B, h_c, w_c = canvases.shape[:3]
    MH, MW = window_extents(out_max_hw)
    dev = canvases.device
    boxes = _long(boxes, dev)
    in_h, in_w, h, w = _box_sizes(obj_hw, boxes, dev)
    resized = resize_u8(objs, (in_h, in_w), (h, w), out_max_hw, method)
    src_p = resized.permute(0, 1, 4, 2, 3).contiguous()
    meta = _window_meta6(boxes, (h_c, w_c))
    hp, wp = _legacy_canvas_pad_hw((h_c, w_c), (MH, MW))
    canvas_p = torch.zeros((B, 4, hp, wp), dtype=torch.uint8, device=dev)
    canvas_p[:, :, :h_c, :w_c] = canvases.permute(0, 3, 1, 2)
    return canvas_p, src_p, meta


def _check_blend_args(plane, src, meta, planar: bool = False) -> None:
    """Raise on anything K4 does not take: device, dtype, shape, layout.
    Packed: plane i32 [B, hp, wp], src i32 [B, N, mh, mw]; planar: plane u8
    [B, 4, hp, wp], src u8 [B, N, 4, mh, mw]; meta i32 [B, N, 6]."""
    px = torch.uint8 if planar else torch.int32
    for name, t, dtype in (("plane", plane, px), ("src", src, px), ("meta", meta, torch.int32)):
        if not torch.is_tensor(t) or t.dtype != dtype:
            raise TypeError(f"{name} must be a {dtype} torch.Tensor")
        if t.device != plane.device:
            raise ValueError(f"{name} is on {t.device}, plane on {plane.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if planar:
        if plane.dim() != 4 or plane.shape[1] != 4:
            raise ValueError(f"plane must be [B, 4, hp, wp], got {tuple(plane.shape)}")
        if src.dim() != 5 or src.shape[0] != plane.shape[0] or src.shape[2] != 4:
            raise ValueError(f"src must be [B, N, 4, mh, mw], got {tuple(src.shape)}")
    else:
        if plane.dim() != 3:
            raise ValueError(f"plane must be [B, hp, wp], got {tuple(plane.shape)}")
        if src.dim() != 4 or src.shape[0] != plane.shape[0]:
            raise ValueError(f"src must be [B, N, mh, mw], got {tuple(src.shape)}")
    if tuple(meta.shape) != (*src.shape[:2], 6):
        raise ValueError(f"meta must be [B, N, 6], got {tuple(meta.shape)}")


def window_blend_reference(plane: torch.Tensor, src: torch.Tensor,
                           meta: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: for each canvas b and each object k in
    list order whose ``valid`` is set, alpha-over ``src[b, k]`` onto the
    plane with its top-left at ``(ws_x + dx, ws_y + dy)``, cut at the
    plane's edge. Updates ``plane`` in place and returns it."""
    _check_blend_args(plane, src, meta)
    _, hp, wp = plane.shape
    mh, mw = src.shape[2], src.shape[3]
    for b, rows in enumerate(meta.tolist()):
        for k, (ws_x, ws_y, dx, dy, _, valid) in enumerate(rows):
            if valid <= 0:
                continue
            x, y = ws_x + dx, ws_y + dy
            x0, y0 = max(x, 0), max(y, 0)
            x1, y1 = min(x + mw, wp), min(y + mh, hp)
            if x1 <= x0 or y1 <= y0:
                continue
            win = plane[b, y0:y1, x0:x1]
            win.copy_(_alpha_over_packed(win, src[b, k, y0 - y:y1 - y, x0 - x:x1 - x]))
    return plane


@functools.lru_cache(maxsize=256)
def _k4_scratch_bytes(B: int, N: int, mh: int) -> int:
    """Bytes of scratch one K4 call takes (its bounds parts), as its launch
    carves it."""
    return _kernel_entry("window_blend_scratch_bytes")(B, N, mh)


@functools.lru_cache(maxsize=256)
def _k4_slices(mh: int) -> Tuple[int, int]:
    """Row slices per placement of K4's bounds and blend launches (their
    grids' y extents; the first is the bounds parts per placement)."""
    out = (ctypes.c_int * 2)()
    _kernel_entry("window_blend_slices")(mh, out)
    return tuple(out)


def _k4_grid_check(B: int, N: int, mh: int) -> None:
    if B * N > _MAX_GRID_X or max(_k4_slices(mh)) > _MAX_GRID_Z:
        raise ValueError(f"B*N = {B * N} or the source height {mh} exceeds the kernel's "
                         "grid limits")


def _blend_launch(name: str, plane, src, meta, *extra) -> None:
    """Launch the K4 entry ``<name>_launch`` (its two launches: bounds, then
    blend) on the current stream over the checked arguments, raise if a
    launch fails, and count the call."""
    B, N = src.shape[0], src.shape[1]
    hp, wp = plane.shape[-2:]
    mh, mw = src.shape[-2:]
    if min(B, N, hp, wp, mh, mw) == 0:
        return
    _k4_grid_check(B, N, mh)
    fn = _kernel_entry(f"{name}_launch")
    dev = plane.device
    # one buffer: the bounds launch's parts, reduced by the blend launch
    scratch = torch.empty(_k4_scratch_bytes(B, N, mh), dtype=torch.uint8, device=dev)
    with _device_guard(dev):
        rc = fn(plane.data_ptr(), src.data_ptr(), meta.data_ptr(), scratch.data_ptr(),
                B, N, hp, wp, mh, mw, *extra, _stream_handle(dev))
    del scratch  # freed to the caching allocator, in stream order
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc} (past ~7,200 "
                           "placements a canvas's rectangles do not fit shared memory)")
    LAUNCHES[name] += 1


def k4_live_rects_reference(src: torch.Tensor, meta: torch.Tensor,
                            plane_hw: Tuple[int, int] | None = None) -> torch.Tensor:
    """Plain version of K4's bounds launch: i32 [B, N, 4] rectangles (x, y,
    w, h), each valid placement's bounding box of its NONZERO source pixels
    (any plane of a planar source) at its origin (ws_x + dx, ws_y + dy);
    (0, 0, 0, 0) for an invalid placement or one with no such pixel. With
    ``plane_hw`` = (hp, wp) only the source pixels that land on the plane
    count, as on the card, where the launch reads no others.

    ``src`` is packed i32 [B, N, mh, mw] or planar u8 [B, N, 4, mh, mw];
    ``meta`` i32 [B, N, 6] (ws_x, ws_y, dx, dy, same, valid)."""
    live = (src != 0).any(dim=2) if src.dim() == 5 else src != 0
    mh, mw = live.shape[-2:]
    m = meta.to(torch.int64)
    x, y = m[..., 0] + m[..., 2], m[..., 1] + m[..., 3]  # each source's origin
    rows = torch.arange(mh, device=src.device)
    cols = torch.arange(mw, device=src.device)
    if plane_hw is not None:
        hp, wp = plane_hw
        on_r = ((y[..., None] + rows) >= 0) & ((y[..., None] + rows) < hp)
        on_c = ((x[..., None] + cols) >= 0) & ((x[..., None] + cols) < wp)
        live = live & on_r[..., :, None] & on_c[..., None, :]
    live_r, live_c = live.any(-1), live.any(-2)
    return _k4_rects(meta, torch.where(live_r, rows, mh).amin(-1),
                     torch.where(live_r, rows + 1, 0).amax(-1),
                     torch.where(live_c, cols, mw).amin(-1),
                     torch.where(live_c, cols + 1, 0).amax(-1))


def _k4_rects(meta, r0, r1, c0, c1) -> torch.Tensor:
    """i32 [B, N, 4] rectangles (x, y, w, h) from each placement's first and
    one-past-last live source row and column [B, N] at its origin; (0, 0,
    0, 0) for an invalid placement or an empty box."""
    m = meta.to(torch.int64)
    x, y = m[..., 0] + m[..., 2], m[..., 1] + m[..., 3]
    keep = (m[..., 5] > 0) & (r1 > r0)
    rect = torch.stack([x + c0, y + r0, c1 - c0, r1 - r0], -1)
    return torch.where(keep[..., None], rect, 0).to(torch.int32)


def k4_live_rects(src: torch.Tensor, meta: torch.Tensor,
                  plane_hw: Tuple[int, int]) -> torch.Tensor:
    """K4's bounds launch alone, on the card (for the card tests; not counted
    in ``LAUNCHES``): its parts, reduced over the row slices here as the
    blend launch reduces them, as :func:`k4_live_rects_reference` returns
    them with ``plane_hw``."""
    if src.device.type != "cuda":
        raise ValueError(f"k4_live_rects runs on cuda, not {src.device}")
    planar = src.dim() == 5
    if (src.dtype != (torch.uint8 if planar else torch.int32) or meta.dtype != torch.int32
            or meta.device != src.device or not (src.is_contiguous() and meta.is_contiguous())
            or tuple(meta.shape) != (*src.shape[:2], 6)):
        raise ValueError("k4_live_rects takes contiguous src and meta as window_blend(_planar)")
    B, N = src.shape[:2]
    mh, mw = src.shape[-2:]
    _k4_grid_check(B, N, mh)
    S = _k4_slices(mh)[0]
    part = torch.empty((B, N, S, 4), dtype=torch.int32, device=src.device)
    with _device_guard(src.device):
        rc = _kernel_entry("window_blend_bounds_launch")(
            src.data_ptr(), meta.data_ptr(), part.data_ptr(), B, N, int(plane_hw[0]),
            int(plane_hw[1]), mh, mw, int(planar), _stream_handle(src.device))
    if rc != 0:
        raise RuntimeError(f"k4_live_rects: kernel launch failed with CUDA error {rc}")
    return _k4_rects(meta, part[..., 0].amin(-1), part[..., 1].amax(-1),
                     part[..., 2].amin(-1), part[..., 3].amax(-1))


def window_blend(plane: torch.Tensor, src: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """Alpha-over every valid object's packed source onto the packed plane
    through its window, in list order. Updates ``plane`` IN PLACE and
    returns it.

    plane i32 [B, hp, wp]; src i32 [B, N, mh, mw] (packed RGBA, zero
    outside each object's live region); meta i32 [B, N, 6] from
    :func:`_window_meta6` (ws_x, ws_y, dx, dy, same, valid).

    On a CUDA device this launches K4 (``csrc/window_blend.cu``) on the
    current stream and raises if the launch fails; on the CPU it runs
    :func:`window_blend_reference`.
    """
    if plane.device.type == "cpu":
        return window_blend_reference(plane, src, meta)
    _check_blend_args(plane, src, meta)
    if plane.device.type != "cuda":
        raise ValueError(f"window_blend runs on cuda or cpu, not {plane.device}")
    _blend_launch("window_blend", plane, src, meta)
    return plane


def window_blend_planar_reference(plane: torch.Tensor, src: torch.Tensor,
                                  meta: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4's planar entry: :func:`window_blend_reference`
    on the planes packed. Updates ``plane`` in place and returns it."""
    _check_blend_args(plane, src, meta, planar=True)
    packed = plane.permute(0, 2, 3, 1).contiguous().view(torch.int32)[..., 0]
    src_v = src.permute(0, 1, 3, 4, 2).contiguous().view(torch.int32)[..., 0]
    window_blend_reference(packed, src_v, meta)
    plane.copy_(packed_to_u8(packed).permute(0, 3, 1, 2))
    return plane


def window_blend_planar(plane: torch.Tensor, src: torch.Tensor,
                        meta: torch.Tensor) -> torch.Tensor:
    """:func:`window_blend` on planar u8 pixels: plane [B, 4, hp, wp], src
    [B, N, 4, mh, mw] (zero outside each live region), meta i32 [B, N, 6].
    Updates ``plane`` IN PLACE and returns it. On a CUDA device this
    launches K4's planar entry (``window_blend_planar_launch``); on the CPU
    it runs :func:`window_blend_planar_reference`."""
    if plane.device.type == "cpu":
        return window_blend_planar_reference(plane, src, meta)
    _check_blend_args(plane, src, meta, planar=True)
    if plane.device.type != "cuda":
        raise ValueError(f"window_blend_planar runs on cuda or cpu, not {plane.device}")
    _blend_launch("window_blend_planar", plane, src, meta)
    return plane


#: the stage variants of benchmarks/bisect_resize.py:353-359
STAGE_VARIANTS = ("full", "no_roll", "no_shift", "no_blend", "dma_only")
#: the meta columns each variant takes as 0, its placement: no_roll at
#: column ws_x (dx = 0), no_shift at row ws_y (dy = 0), dma_only both
STAGE_ZEROED = {"full": (), "no_roll": (2,), "no_shift": (3,), "no_blend": (),
                "dma_only": (2, 3)}
#: the variants that alpha-over; the others write every window back unchanged
STAGE_BLENDS = ("full", "no_roll", "no_shift")


def _zero_columns(meta: torch.Tensor, cols: Sequence[int]) -> torch.Tensor:
    """The meta with columns ``cols`` set to 0 (a copy; ``meta`` itself when
    there are none)."""
    if not cols:
        return meta
    out = meta.clone()
    out[..., list(cols)] = 0
    return out


def _check_variant(variant: str) -> None:
    if variant not in STAGE_VARIANTS:
        raise ValueError(f"variant must be one of {STAGE_VARIANTS}, got {variant!r}")


def window_blend_stage_reference(plane: torch.Tensor, src: torch.Tensor,
                                 meta: torch.Tensor, variant: str) -> torch.Tensor:
    """Plain PyTorch version of the stage variants: ``full``, ``no_roll``
    and ``no_shift`` are :func:`window_blend_reference` on the meta with
    dx, or dy, taken as 0; ``no_blend`` and ``dma_only`` write every window
    back unchanged, so the plane is returned as it is."""
    _check_blend_args(plane, src, meta)
    _check_variant(variant)
    if variant not in STAGE_BLENDS:
        return plane
    return window_blend_reference(plane, src, _zero_columns(meta, STAGE_ZEROED[variant]))


def window_blend_stage(plane: torch.Tensor, src: torch.Tensor, meta: torch.Tensor,
                       variant: str) -> torch.Tensor:
    """One timing-only stage variant of K4 (the counterpart of
    benchmarks/bisect_resize.py ``make_variant``, row 15): ``variant`` in
    :data:`STAGE_VARIANTS`. Arguments and in-place update as
    :func:`window_blend`. On a CUDA device this launches
    ``window_blend_stage_launch`` on the meta with the variant's
    :data:`STAGE_ZEROED` columns zeroed (a copy), blending or not as
    :data:`STAGE_BLENDS` says; it moves K4's bytes in every variant. On the
    CPU it runs :func:`window_blend_stage_reference`."""
    if plane.device.type == "cpu":
        return window_blend_stage_reference(plane, src, meta, variant)
    _check_blend_args(plane, src, meta)
    _check_variant(variant)
    if plane.device.type != "cuda":
        raise ValueError(f"window_blend_stage runs on cuda or cpu, not {plane.device}")
    _blend_launch("window_blend_stage", plane, src, _zero_columns(meta, STAGE_ZEROED[variant]),
                  int(variant in STAGE_BLENDS), 0)  # keep_mask 0
    return plane


def _pallas_blend_packed(canvas_v: torch.Tensor, src_v: torch.Tensor,
                         meta: torch.Tensor, interpret: bool = False) -> torch.Tensor:
    """Counterpart of the packed window-blend launchers: rows 3
    (``_pallas_blend_packed`` :2332), 5 (``_pallas_blend_packed_pipelined``
    :1516), 6 (``_pallas_blend_packed_clamped`` :1999), 7
    (``_pallas_blend_clamped_batchsrc`` :1688), 8 (``_pallas_blend_resident``
    :1781), 9 (``_pallas_blend_band`` :1871) and 10
    (``_pallas_blend_clamped_pipelined`` :1963). They differ only in the
    TPU's memory schedule (grid over canvases or objects, window, band or
    resident-canvas DMAs, single or double buffering, one source DMA per
    object or per canvas), which Hopper has no counterpart to, so all seven
    are :func:`window_blend` (K4). ``interpret`` is accepted and ignored.
    Updates ``canvas_v`` in place and returns it."""
    del interpret
    return window_blend(canvas_v, src_v, meta)


_pallas_blend_packed_pipelined = _pallas_blend_packed
_pallas_blend_packed_clamped = _pallas_blend_packed
_pallas_blend_clamped_pipelined = _pallas_blend_packed
_pallas_blend_clamped_batchsrc = _pallas_blend_packed
_pallas_blend_resident = _pallas_blend_packed
_pallas_blend_band = _pallas_blend_packed


def _pallas_blend_rowbaked(canvas_v: torch.Tensor, src_v: torch.Tensor,
                           meta: torch.Tensor, interpret: bool = False) -> torch.Tensor:
    """Counterpart of row 11's launcher (JAX :2201): row-baked sources
    [B, N, MH, mw_a] rolled by ``dx`` only, so K4 with ``dy`` taken as 0.
    A capped origin can leave ``dx >= 128``; the lanes the TPU masks then lie
    past ``ws_x + MW = wp``, the plane's edge, where K4 cuts. Updates
    ``canvas_v`` in place and returns it."""
    del interpret
    return window_blend(canvas_v, src_v, _zero_columns(meta, (3,)))


def _pallas_blend_aligned(canvas_v: torch.Tensor, src_v: torch.Tensor,
                          meta: torch.Tensor, interpret: bool = False) -> torch.Tensor:
    """Counterpart of row 4's launcher (JAX :1363): whole-window sources
    [B, N, MH, MW] blended at their window origins, so K4 with ``dx`` and
    ``dy`` taken as 0. The TPU kernel blends ``where(valid, src, 0)``: an
    all-zero source leaves the plane unchanged under Pillow's rule, which is
    K4's skip of an invalid object. Updates ``canvas_v`` in place and
    returns it."""
    del interpret
    return window_blend(canvas_v, src_v, _zero_columns(meta, (2, 3)))


def _pallas_blend_planar(canvas_p: torch.Tensor, src_p: torch.Tensor,
                         meta: torch.Tensor, interpret: bool = False) -> torch.Tensor:
    """Counterpart of row 2's launcher (JAX :1094): planar u8 canvas
    [B, 4, Hp, Wp] (padded by a window) and sources [B, N, 4, mh_a, mw_a].
    The TPU kernel rolls by ``dx`` with no lane mask; its wrapped lanes come
    from the zero pad (``MW - mw_a >= 128 > dx``), so this is K4's placement
    and cut, on the planar entry. Updates ``canvas_p`` in place and returns
    it."""
    del interpret
    return window_blend_planar(canvas_p, src_p, meta)


def _blend_clamped_finish_impl(canvas_v, src_v, meta, out_hw, interpret, packed):
    """Clamped blend, then the crop to ``out_hw``: u8 RGBA [B, h_c, w_c, 4],
    or with ``packed`` the packed int32 plane [B, h_c, w_c], contiguous
    (JAX :2034)."""
    out_v = _pallas_blend_packed_clamped(canvas_v, src_v, meta, interpret)
    crop = out_v[:, :out_hw[0], :out_hw[1]]
    return crop.contiguous() if packed else packed_to_u8(crop)


def _pallas_blend_clamped_packed_out(canvas_v, src_v, meta, out_hw, interpret=False):
    return _blend_clamped_finish_impl(canvas_v, src_v, meta, out_hw, interpret,
                                      packed=True)


def composite_batch_hybrid_packed(
    canvases: torch.Tensor,
    objs: torch.Tensor,
    obj_hw,
    boxes,
    out_max_hw: Tuple[int, int] | None = None,
    method: str = "lanczos",
    interpret: bool = False,
    pipelined: bool = False,
    clamped: bool = False,
    rowbaked: bool = False,
    band: bool = False,
    batchsrc: bool = False,
    resident: bool = False,
    packed_out: bool = False,
) -> torch.Tensor:
    """Two-program compose (port of JAX :2373): the producer resizes every
    object with the traced tables and the exact resample, then K4 blends the
    packed sources through their windows.

    canvases u8 [B, H, W, 4] (never written); objs u8 [B, N, ph, pw, 4]
    (a shared [1, N, ...] broadcasts); obj_hw [B, N, 2] (h, w); boxes
    [B, N, 4]. Boxes resize to max(1, x2-x1) x max(1, y2-y1), cut at the
    envelope ``out_max_hw`` (default (ph, pw)) rounded up to (8, 128); an
    origin off the canvas drops the placement. Returns u8 [B, H, W, 4], or
    with ``packed_out`` (the plain clamped path only) the packed int32
    [B, H, W]. The output equals :func:`ops.compose.composite_batch` with
    the rounded envelope.

    The flags pick JAX's producer and launcher, in JAX's precedence:
    ``rowbaked`` (its own producer, row 11), then on the clamped producer
    (selected by ``clamped``, ``band``, ``batchsrc`` or ``resident``)
    ``resident`` (row 8), ``batchsrc`` (7), ``band`` (9), ``pipelined``
    (10) and the finish path (6); else the unclamped producer with rows 5
    or 3. Every launcher runs K4. ``interpret`` is ignored.
    """
    del interpret
    if packed_out and not (clamped and not (band or batchsrc or resident
                                            or pipelined or rowbaked)):
        raise ValueError("packed_out is only supported on the default clamped path")
    h_c, w_c = canvases.shape[1], canvases.shape[2]
    env = _blend_envelope(objs, out_max_hw)
    if rowbaked:
        canvas_v, src_v, meta = _hybrid_producer_rowbaked(canvases, objs, obj_hw, boxes,
                                                          env, method)
        return packed_to_u8(_pallas_blend_rowbaked(canvas_v, src_v, meta)[:, :h_c, :w_c])
    if clamped or band or batchsrc or resident:
        canvas_v, src_v, meta = _hybrid_producer_clamped(canvases, objs, obj_hw, boxes,
                                                         env, method)
        if not (resident or batchsrc or band or pipelined):  # the finish path (row 6)
            if packed_out:
                return _pallas_blend_clamped_packed_out(canvas_v, src_v, meta, (h_c, w_c))
            return _blend_clamped_finish_impl(canvas_v, src_v, meta, (h_c, w_c), False,
                                              packed=False)
        # rows 8, 7, 9 and 10 are one K4 launch. JAX takes the resident kernel
        # only while the canvas fits its VMEM budget (_RESIDENT_VMEM_BUDGET_BYTES
        # :1777, a TPU limit) and the windowed kernels otherwise; both branches
        # compute the same blend, so the port has no budget.
        return packed_to_u8(_pallas_blend_packed(canvas_v, src_v, meta)[:, :h_c, :w_c])
    canvas_v, src_v, meta = _hybrid_producer(canvases, objs, obj_hw, boxes, env, method)
    # rows 3 and 5 (pipelined) are one K4 launch
    return packed_to_u8(_pallas_blend_packed(canvas_v, src_v, meta)[:, :h_c, :w_c])


def composite_batch_aligned(
    canvases: torch.Tensor,
    objs: torch.Tensor,
    obj_hw,
    boxes,
    out_max_hw: Tuple[int, int] | None = None,
    method: str = "lanczos",
    interpret: bool = False,
) -> torch.Tensor:
    """Shift-baked compose (port of JAX :1433, row 4): every object resampled
    straight into its window position, then K4 blends the whole windows.
    Arguments and result as :func:`composite_batch_hybrid_packed`; equal to
    :func:`ops.compose.composite_batch` with the rounded envelope wherever a
    box fits the window (the shifted tables equal the unshifted ones row for
    row). ``interpret`` is ignored."""
    del interpret
    h_c, w_c = canvases.shape[1], canvases.shape[2]
    canvas_v, src_v, meta = _hybrid_producer_aligned(
        canvases, objs, obj_hw, boxes, _blend_envelope(objs, out_max_hw), method)
    return packed_to_u8(_pallas_blend_aligned(canvas_v, src_v, meta)[:, :h_c, :w_c])


def composite_batch_hybrid(
    canvases: torch.Tensor,
    objs: torch.Tensor,
    obj_hw,
    boxes,
    out_max_hw: Tuple[int, int] | None = None,
    method: str = "lanczos",
    interpret: bool = False,
) -> torch.Tensor:
    """Planar two-program compose (port of JAX :1130, row 2): the traced
    resize into planar u8 sources, then K4's planar entry on the planar
    canvas padded by a window. Arguments and result as
    :func:`composite_batch_hybrid_packed`. ``interpret`` is ignored."""
    del interpret
    h_c, w_c = canvases.shape[1], canvases.shape[2]
    canvas_p, src_p, meta = _hybrid_producer_planar(
        canvases, objs, obj_hw, boxes, _blend_envelope(objs, out_max_hw), method)
    out_p = _pallas_blend_planar(canvas_p, src_p, meta)
    return out_p[:, :, :h_c, :w_c].permute(0, 2, 3, 1).contiguous()


# ------------------- gen-1: the planar fused compose on K1 -------------------

def _pallas_compose_planar(canvas_p: torch.Tensor, objs_p: torch.Tensor, kh: torch.Tensor,
                           kv_t: torch.Tensor, meta: torch.Tensor,
                           interpret: bool = False) -> torch.Tensor:
    """Counterpart of row 1's launcher (JAX :937) on K1, which computes the
    same thing in NHWC: exact separable resample from the supplied tables,
    identity copy where ``same``, alpha-over at ``(ws_x + dx, ws_y + dy)``,
    cut at the padded canvas, invalid objects dropped.

    canvas_p u8 [B, 4, Hp, Wp]; objs_p u8 [B, N, 4, ph, pw]; kh i32
    [B, N, mw_out, pw]; kv_t i32 [B, N, ph, mh_out] (transposed, as JAX
    takes it); meta i32 [B, N, 6]. The transposes to and from K1's layout
    are plain torch. Updates ``canvas_p`` in place and returns it;
    ``interpret`` is ignored."""
    del interpret
    mh_out, mw_out = kv_t.shape[3], kh.shape[2]
    canvas = canvas_p.permute(0, 2, 3, 1).contiguous()
    x = meta[..., 0] + meta[..., 2]
    y = meta[..., 1] + meta[..., 3]
    boxes = torch.stack([x, y, x + mw_out, y + mh_out], dim=-1).to(torch.int32)
    flags = (meta[..., 5] > 0).to(torch.uint8) * FLAG_LIVE + (
        meta[..., 4] > 0).to(torch.uint8) * FLAG_IDENTITY
    fused_compose(canvas, objs_p.permute(0, 1, 3, 4, 2).contiguous(),
                  kh.to(torch.int32).contiguous(),
                  kv_t.transpose(2, 3).to(torch.int32).contiguous(),
                  boxes.contiguous(), flags.contiguous())
    canvas_p.copy_(canvas.permute(0, 3, 1, 2))
    return canvas_p


def _pallas_args(canvases, objs, obj_hw, boxes, kh, kv):
    """K1's arguments for a gen-1 compose: (a new NHWC canvas holding
    ``canvases``, objects, kh, kv, boxes i32, flags), on the canvases'
    device. ``FLAG_LIVE`` comes from ``_window_meta6``'s drop rule and
    ``FLAG_IDENTITY`` from the box size equal to the object's."""
    dev = canvases.device
    boxes = _long(boxes, dev)
    in_h, in_w, h, w = _box_sizes(obj_hw, boxes, dev)
    meta = _window_meta6(boxes, tuple(canvases.shape[1:3]))
    flags = (meta[..., 5] > 0).to(torch.uint8) * FLAG_LIVE + (
        (w == in_w) & (h == in_h)).to(torch.uint8) * FLAG_IDENTITY
    table = lambda t: torch.as_tensor(t, device=dev).to(torch.int32).contiguous()  # noqa: E731
    return (canvases.to(torch.uint8).contiguous().clone(),
            objs.to(dev, torch.uint8).contiguous(), table(kh), table(kv),
            boxes.to(torch.int32).contiguous(), flags.contiguous())


def composite_batch_pallas(
    canvases: torch.Tensor,
    objs: torch.Tensor,
    obj_hw,
    boxes,
    kh,
    kv,
    interpret: bool = False,
) -> torch.Tensor:
    """Gen-1 fused compose over a batch (port of JAX :983, row 1), on K1.

    canvases u8 [B, H, W, 4] (never written); objs u8 [B, N, ph, pw, 4];
    obj_hw [B, N, 2]; boxes [B, N, 4]; kh i32 [B, N, mw_out, pw] and kv i32
    [B, N, mh_out, ph], host-exact or traced. JAX's (8, 128) table padding
    and the ``kv`` transpose are TPU layout and do not carry over. Returns u8
    [B, H, W, 4]; bit-exact vs PIL with host tables. ``interpret`` is
    ignored."""
    del interpret
    canvas, *rest = _pallas_args(canvases, objs, obj_hw, boxes, kh, kv)
    return fused_compose(canvas, *rest)


def composite_batch_pallas_host_tables(
    canvases,
    objs,
    obj_hw,
    boxes,
    out_max_hw: Tuple[int, int] | None = None,
    method: str = "lanczos",
    interpret: bool = False,
) -> torch.Tensor:
    """:func:`composite_batch_pallas` with Pillow-exact host tables for
    concrete boxes (port of JAX :4266): bit-exact vs PIL. ``obj_hw`` and
    ``boxes`` are host ints; ``canvases`` and ``objs`` are tensors (their
    device is the one used) or numpy arrays, which go to the CUDA card."""
    del interpret
    if not torch.is_tensor(canvases):
        canvases = torch.from_numpy(np.asarray(canvases)).to(resolve_device("cuda"))
    objs = torch.as_tensor(objs).to(canvases.device)
    obj_hw = np.asarray(obj_hw.cpu() if torch.is_tensor(obj_hw) else obj_hw, np.int64)
    boxes = np.asarray(boxes.cpu() if torch.is_tensor(boxes) else boxes, np.int64)
    pad = tuple(objs.shape[2:4])
    kh, kv, _, _ = fused_tables_prep(obj_hw, boxes, tuple(canvases.shape[1:3]), pad,
                                     out_max_hw or pad, method)
    return composite_batch_pallas(canvases, objs, obj_hw, boxes, kh, kv)
