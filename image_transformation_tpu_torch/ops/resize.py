"""Pillow-exact separable resampling on torch tensors.

Port of image_transformation_tpu/ops/resize.py (the exact path only).
Pillow's 8-bit resample is fixed point: coefficients are quantized to
int32 * 2^22 and accumulated in int32 with a +2^21 rounding bias
(Resample.c, PRECISION_BITS = 22):

    out = clip8( KV @ clip8( img @ KH^T ) )

Here the two passes are float64 matmuls. They are exact: every product is
an integer below 2^39 and every row sum stays below 2^31, far inside
float64's 2^53 exact-integer range, so any summation order gives Pillow's
int32 result (torch has no integer matmul on CUDA). The TPU limb split and
its "wide" chunked path are not needed here.

RGBA handling matches Pillow bit for bit: premultiply to "RGBa" (MULDIV255
rounding), resample each channel, unpremultiply (floor(255*c/a), alpha==0
passthrough), with Pillow's plain-copy shortcut when sizes are unchanged.

Every function computes on the device of the tensors it is given.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

PRECISION_BITS = 22  # Pillow: 32 - 8 - 2
_HALF = 1 << (PRECISION_BITS - 1)

_SUPPORT = {"lanczos": 3.0, "bilinear": 1.0}


# --------------------- host coefficient tables (exact) ---------------------

def _np_lanczos3(x: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.where(np.abs(x) < 3.0, np.sinc(x) * np.sinc(x / 3.0), 0.0)
    return out


def _np_bilinear(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


_NP_FILTERS = {"lanczos": _np_lanczos3, "bilinear": _np_bilinear}


@functools.lru_cache(maxsize=4096)
def build_coeffs_host(
    in_size: int,
    out_size: int,
    in_max: int,
    out_max: int,
    method: str = "lanczos",
    box: Tuple[float, float] = (0.0, -1.0),
) -> np.ndarray:
    """Bit-exact Pillow coefficient table, int32 [out_max, in_max].

    Float64 window/normalization and the C-cast half-away-from-zero
    quantization reproduce precompute_coeffs + normalize_coeffs_8bpc.
    ``box`` = (in0, in1) supports PIL's fractional source boxes (used by
    the reduce() pre-pass of thumbnail); in1 < 0 means the full extent.
    """
    filt = _NP_FILTERS[method]
    out_size = max(1, out_size)
    in0, in1 = box
    if in1 < 0:
        in1 = float(in_size)
    scale = (in1 - in0) / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT[method] * filterscale
    ss = 1.0 / filterscale

    table = np.zeros((out_max, in_max), np.int32)
    for o in range(min(out_size, out_max)):
        center = in0 + (o + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(in_size, int(center + support + 0.5))
        i = np.arange(xmin, xmax, dtype=np.float64)
        k = filt((i - center + 0.5) * ss)
        s = k.sum()
        if s != 0.0:
            k = k / s
        q = np.trunc(
            k * (1 << PRECISION_BITS) + np.where(k < 0, -0.5, 0.5)
        ).astype(np.int32)
        table[o, xmin:xmax] = q
    return table


# ----------------------- exact fixed-point resample -----------------------

def _clip8(ss: torch.Tensor) -> torch.Tensor:
    """Pillow clip8 of an exact float64 accumulator that carries +2^21:
    arithmetic ``>> 22`` clamped to [0, 255], as int32."""
    return (ss.to(torch.int64) >> PRECISION_BITS).clamp_(0, 255).to(torch.int32)


def resample_fixed(
    img: torch.Tensor, kh_i32: torch.Tensor, kv_i32: torch.Tensor
) -> torch.Tensor:
    """Two-pass fixed-point resample, bit-exact vs Pillow given its tables.

    img: [Hin_max, Win_max, C] holding uint8 values (any integer dtype).
    kh_i32: [Wout_max, Win_max]; kv_i32: [Hout_max, Hin_max].
    Returns int32 [Hout_max, Wout_max, C] of uint8 values.
    """
    f = torch.float64
    # horizontal pass first (Pillow order): tmp[h,o,c] = clip8(half + Σ_i kh[o,i] p[h,i,c])
    ss_h = torch.einsum("hic,oi->hoc", img.to(f), kh_i32.to(f)) + _HALF
    tmp = _clip8(ss_h)
    ss_v = torch.einsum("hwc,oh->owc", tmp.to(f), kv_i32.to(f)) + _HALF
    return _clip8(ss_v)


# ----------------------- RGBA premultiplied handling -----------------------

def premultiply_rgba(img: torch.Tensor) -> torch.Tensor:
    """RGBA -> RGBa, bit-exact vs Pillow's MULDIV255 (round(c*a/255)).
    Returns int32 [..., 4]."""
    rgba = img.to(torch.int32)
    a = rgba[..., 3:4]
    tmp = rgba[..., :3] * a + 128
    rgb = ((tmp >> 8) + tmp) >> 8
    return torch.cat([rgb, a], dim=-1)


def unpremultiply_rgba(img: torch.Tensor) -> torch.Tensor:
    """RGBa -> RGBA, bit-exact vs Pillow: floor(255*c/a), passthrough at
    a=0. Returns int32 [..., 4]."""
    rgba = img.to(torch.int32)
    a = rgba[..., 3:4]
    q = torch.div(255 * rgba[..., :3], a.clamp(min=1), rounding_mode="floor")
    rgb = torch.where(a == 0, rgba[..., :3], q.clamp(max=255))
    return torch.cat([rgb, a], dim=-1)


# ------------------------------ public entry ------------------------------

def resize_with_tables(
    img: torch.Tensor,
    kh_i32: torch.Tensor,
    kv_i32: torch.Tensor,
    same_size: bool,
) -> torch.Tensor:
    """Resample uint8-valued [Hm, Wm, C] with given tables; RGBA inputs take
    the premultiplied path. ``same_size`` selects Pillow's plain-copy
    shortcut (a copy of the padded source, cut or zero-padded to the output
    extent). Returns int32 [Hout_max, Wout_max, C]."""
    channels = img.shape[2]
    out_max_h, out_max_w = kv_i32.shape[0], kh_i32.shape[0]
    if same_size:
        out = torch.zeros(
            (out_max_h, out_max_w, channels), dtype=torch.int32, device=img.device
        )
        copy_h = min(img.shape[0], out_max_h)
        copy_w = min(img.shape[1], out_max_w)
        out[:copy_h, :copy_w] = img[:copy_h, :copy_w].to(torch.int32)
        return out
    src = premultiply_rgba(img) if channels == 4 else img
    out = resample_fixed(src, kh_i32, kv_i32)
    return unpremultiply_rgba(out) if channels == 4 else out


def resize_exact_u8(
    img_u8: torch.Tensor,
    in_hw: Tuple[int, int],
    out_hw: Tuple[int, int],
    out_max_hw: Tuple[int, int],
    method: str = "lanczos",
) -> torch.Tensor:
    """Concrete-size resample with host-built tables — bit-exact vs PIL.

    img_u8: uint8 [Hm, Wm, C]. Returns uint8 [out_max_h, out_max_w, C] with
    the live region [out_h, out_w] and zeros beyond it."""
    in_h, in_w = int(in_hw[0]), int(in_hw[1])
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    kh = build_coeffs_host(in_w, out_w, img_u8.shape[1], out_max_hw[1], method)
    kv = build_coeffs_host(in_h, out_h, img_u8.shape[0], out_max_hw[0], method)
    same = (out_h == in_h) and (out_w == in_w)
    dev = img_u8.device
    out = resize_with_tables(
        img_u8, torch.from_numpy(kh).to(dev), torch.from_numpy(kv).to(dev), same
    )
    return out.to(torch.uint8)
