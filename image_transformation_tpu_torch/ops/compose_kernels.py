"""K1: the fused exact resize + alpha-over kernel and its plain version.

Counterpart of image_transformation_tpu/ops/compose_pallas.py's gen-2
path (``fused_v2_host_tables_prep`` -> ``_fused_v2_exact_apply`` ->
``_make_fused_kernel_v2``). The kernel itself is CUDA C++ for sm_90a in
``csrc/fused_compose.cu``; this module holds

- :func:`fused_tables_prep`: the host side — Pillow-exact int32 coefficient
  tables and the live/identity flags, in the layout K1 takes;
- :func:`fused_compose`: the wrapper. On a CUDA tensor it launches K1 (or
  raises); on a CPU tensor it runs :func:`fused_compose_reference`;
- :func:`fused_compose_reference`: the plain PyTorch version, same
  signature, built from ops.resize and ops.compose;
- ``LAUNCHES``: the count of K1 launches, raised by one per launch.

Both update the canvas in place and return it. The output is bit-exact vs
PIL (LANCZOS resize, then ``Image.alpha_composite``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from .compose import _blend_window
from .resize import build_coeffs_host, resize_with_tables

FLAG_LIVE = 1
FLAG_IDENTITY = 2

#: K1 launches since the last reset (one per fused_compose call on CUDA)
LAUNCHES = {"fused_compose": 0}

_MAX_GRID_Z = 65535  # CUDA's limit on gridDim.z, which carries B*N


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fused_tables_prep(
    obj_hw: np.ndarray,
    boxes: np.ndarray,
    canvas_hw: Tuple[int, int],
    obj_pad_hw: Tuple[int, int],
    out_max_hw: Tuple[int, int],
):
    """Host side of the exact fused compose (LANCZOS tables).

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
            kh[b, k] = build_coeffs_host(ow, w_t, pw, mw)
            kv[b, k] = build_coeffs_host(oh, h_t, ph, mh)
            drop = x1 < 0 or y1 < 0 or x1 >= w_c or y1 >= h_c
            flags[b, k] = (0 if drop else FLAG_LIVE) | (
                FLAG_IDENTITY if (w_t == ow and h_t == oh) else 0
            )
    return kh, kv, boxes.astype(np.int32), flags


def _check_args(canvas, objects, kh, kv, boxes, flags) -> None:
    """Raise on anything K1 does not take: device, dtype, shape, layout."""
    named = dict(canvas=canvas, objects=objects, kh=kh, kv=kv, boxes=boxes,
                 flags=flags)
    dtypes = dict(canvas=torch.uint8, objects=torch.uint8, kh=torch.int32,
                  kv=torch.int32, boxes=torch.int32, flags=torch.uint8)
    for name, t in named.items():
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if t.device != canvas.device:
            raise ValueError(
                f"{name} is on {t.device}, canvas on {canvas.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if canvas.dim() != 4 or canvas.shape[3] != 4:
        raise ValueError(f"canvas must be [B, H, W, 4], got {tuple(canvas.shape)}")
    B = canvas.shape[0]
    if objects.dim() != 5 or objects.shape[4] != 4 or objects.shape[0] not in (1, B):
        raise ValueError(
            f"objects must be [1 or B, N, ph, pw, 4], got {tuple(objects.shape)}"
        )
    _, N, ph, pw, _ = objects.shape
    if kh.dim() != 4 or tuple(kh.shape[:2]) != (B, N) or kh.shape[3] != pw:
        raise ValueError(f"kh must be [B, N, mw, pw], got {tuple(kh.shape)}")
    if kv.dim() != 4 or tuple(kv.shape[:2]) != (B, N) or kv.shape[3] != ph:
        raise ValueError(f"kv must be [B, N, mh, ph], got {tuple(kv.shape)}")
    if tuple(boxes.shape) != (B, N, 4):
        raise ValueError(f"boxes must be [B, N, 4], got {tuple(boxes.shape)}")
    if tuple(flags.shape) != (B, N):
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


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _kernel_entry():
    from ._build import load_library

    fn = load_library().fused_compose_launch
    if fn.argtypes != _ARGTYPES:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


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
    if B * N > _MAX_GRID_Z:
        raise ValueError(f"B*N = {B * N} exceeds the kernel's grid limit {_MAX_GRID_Z}")
    if canvas.data_ptr() % 4 or objects.data_ptr() % 4:
        raise ValueError("canvas and objects must be 4-byte aligned (uchar4 pixels)")
    fn = _kernel_entry()
    dev = canvas.device
    tmp = torch.empty((B, N, 4, ph, mw), dtype=torch.uint8, device=dev)
    res = torch.empty((B, N, mh, mw, 4), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            canvas.data_ptr(), objects.data_ptr(), kh.data_ptr(), kv.data_ptr(),
            boxes.data_ptr(), flags.data_ptr(), tmp.data_ptr(), res.data_ptr(),
            B, Bo, N, H, W, ph, pw, mh, mw, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_compose: kernel launch failed with CUDA error {rc}")
    LAUNCHES["fused_compose"] += 1
    return canvas
