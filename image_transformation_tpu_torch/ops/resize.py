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

Two coefficient table paths, as in the JAX package: the host tables
(float64, bit-exact vs Pillow) and the traced float32 tables
(``build_coeffs_traced``, resize.py:142-193), which builds the tables from
size tensors on the device. The float32 path follows the JAX op order
exactly and sums each row's weights tap by tap in index order, so the CUDA
kernel that builds the same tables (csrc/fused_v3.cu) equals it bit for bit.

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


# ------------------------- filters (f32, traced) -------------------------

# lanczos3 as a degree-12 polynomial in u = x^2 (the JAX package's Chebyshev
# fit, resize.py:56-62). Every constant is an exact float32 value.
_LANCZOS3_POLY_U = (
    0.019992724061012268, 0.12934572994709015, -0.43056443333625793,
    0.2683068513870239, 0.3336562514305115, -0.6404303312301636,
    0.4925920069217682, -0.2359950840473175, 0.08007098734378815,
    -0.020507415756583214, 0.004155285656452179, -0.0007197138038463891,
    9.71919289440848e-05,
)
_F32 = torch.float32


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=_F32)


def _filter_lanczos3(x: torch.Tensor) -> torch.Tensor:
    # t clamps to the fit domain: out-of-support entries are masked to zero
    t = torch.minimum(x * x * _f32(1.0 / 4.5) - _f32(1.0), _f32(1.0))
    acc = torch.full_like(t, _LANCZOS3_POLY_U[-1])
    for c in reversed(_LANCZOS3_POLY_U[:-1]):
        acc = acc * t + _f32(c)
    return torch.where(x.abs() < 3.0, acc, _f32(0.0))


def _filter_bilinear(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(_f32(1.0) - x.abs(), min=0.0)


_FILTERS = {"lanczos": _filter_lanczos3, "bilinear": _filter_bilinear}


# ------------------- traced coefficient tables (f32) -------------------

def _trunc_f32(x: torch.Tensor) -> torch.Tensor:
    """Round toward zero (the floor form of the JAX in-kernel tables)."""
    return torch.where(x >= 0, torch.floor(x), -torch.floor(-x))


def _window_bounds(in_size, out_size, out_max: int, method: str, out_offset):
    """The window geometry of every output row, in the JAX function's f32 op
    order: (in_f, out_f, o, center, xmin, xmax, inv_fs), each row's values
    shaped [..., out_max, 1] (``in_f``, ``out_f``, ``inv_fs`` [...])."""
    in_f = torch.as_tensor(in_size).to(_F32)
    dev = in_f.device
    out_f = torch.clamp(torch.as_tensor(out_size, device=dev).to(_F32), min=1.0)
    off = torch.as_tensor(out_offset, device=dev).to(_F32)
    scale = in_f / out_f
    fs = torch.clamp(scale, min=1.0)
    support = _f32(_SUPPORT[method]) * fs
    col = (..., None, None)
    o = torch.arange(out_max, dtype=_F32, device=dev)[:, None] - off[col]
    center = (o + 0.5) * scale[col]
    xmin = torch.clamp(_trunc_f32(center - support[col] + 0.5), min=0.0)
    xmin = torch.minimum(xmin, in_f[col])
    xmax = torch.clamp(_trunc_f32(center + support[col] + 0.5), min=0.0)
    xmax = torch.minimum(xmax, in_f[col])
    return in_f, out_f, o, center, xmin, xmax, _f32(1.0) / fs


def row_windows(in_size, out_size, out_max: int, method: str = "lanczos",
                out_offset=0) -> torch.Tensor:
    """int64 [..., out_max, 2]: each output row's tap window [lo, hi) as
    :func:`resample_coeff_matrix` computes it, with rows outside
    [out_offset, out_offset + out_size) empty (hi = lo). Every nonzero of
    :func:`build_coeffs_traced` lies inside its row's window; the plain
    counterpart of the CUDA kernel's ``row_params`` (csrc/fused_v3.cu)."""
    _, out_f, o, _, xmin, xmax, _ = _window_bounds(in_size, out_size, out_max, method,
                                                   out_offset)
    live = (o >= 0) & (o < out_f[..., None, None])
    return torch.cat([xmin, torch.where(live, xmax, xmin)], -1).to(torch.int64)


def resample_coeff_matrix(
    in_size,
    out_size,
    in_max: int,
    out_max: int,
    method: str = "lanczos",
    out_offset=0,
) -> torch.Tensor:
    """Float32 [..., out_max, in_max] normalized coefficients for size
    tensors ``in_size`` / ``out_size`` of any (equal) shape ``[...]``.

    Rows outside [out_offset, out_offset + out_size) and taps >= in_size
    are zero. Op order is the JAX function's: ``center = (o + 0.5) * scale``,
    window bounds by truncation (:func:`_window_bounds`), ``w / wsum``, then
    the row mask. ``wsum`` adds the taps one by one in index order (a loop
    over taps, vectorised over rows), which is the order the CUDA kernel uses.
    """
    filt = _FILTERS[method]
    in_f, out_f, o, center, xmin, xmax, inv_fs = _window_bounds(
        in_size, out_size, out_max, method, out_offset)
    dev = in_f.device
    lead = torch.broadcast_shapes(in_f.shape, out_f.shape)
    col = (..., None, None)
    i = torch.arange(in_max, dtype=_F32, device=dev)[None, :]
    window = (i >= xmin) & (i < xmax)
    w = filt((i - center + 0.5) * inv_fs[col]) * window.to(_F32)
    w = w.expand(*lead, out_max, in_max)
    wsum = torch.zeros((*lead, out_max), dtype=_F32, device=dev)
    for tap in range(in_max):
        wsum = wsum + w[..., tap]
    wsum = wsum[..., None]
    w = w / torch.where(wsum != 0.0, wsum, _f32(1.0))
    return w * ((o >= 0) & (o < out_f[col])).to(_F32)


def quantize_coeffs(w_f32: torch.Tensor) -> torch.Tensor:
    """Quantize normalized f32 coefficients to Pillow's int32 fixed point
    (half away from zero, then truncation)."""
    scaled = w_f32 * _f32(float(1 << PRECISION_BITS))
    half = torch.where(w_f32 < 0, _f32(-0.5), _f32(0.5))
    return _trunc_f32(scaled + half).to(torch.int32)


def build_coeffs_traced(in_size, out_size, in_max: int, out_max: int,
                        method: str = "lanczos", out_offset=0) -> torch.Tensor:
    """int32 [..., out_max, in_max] Pillow tables from size tensors."""
    return quantize_coeffs(
        resample_coeff_matrix(in_size, out_size, in_max, out_max, method, out_offset)
    )


def _grows(in_size, out_size) -> torch.Tensor:
    """Where a size grows, decided as K2 decides it: ``in / max(out, 1) < 1``
    in float32."""
    in_f = torch.as_tensor(in_size).to(_F32)
    out_f = torch.clamp(torch.as_tensor(out_size, device=in_f.device).to(_F32), min=1.0)
    return in_f / out_f < 1.0


def _upscale_windows(in_size, out_size, out_max: int):
    """The exact-argument form's integers for each output row ``o`` of a
    growing size: ``c2 = (2o + 1) in`` (twice the output size times the
    centre) and the window ``[lo, hi) = [trunc(center - 2.5),
    trunc(center + 3.5))`` clamped to ``[0, in]``, with ``o`` int64
    ``[out_max, 1]``, ``c2``, ``lo``, ``hi`` int64 ``[..., out_max, 1]``,
    ``n_out = max(out, 1)`` ``[..., 1, 1]`` and the float32 reciprocal
    ``1 / (2 out)``."""
    in_i = torch.as_tensor(in_size).to(torch.int64)
    dev = in_i.device
    out_i = torch.clamp(torch.as_tensor(out_size, device=dev).to(torch.int64), min=1)
    col = (..., None, None)
    n_in, n_out = in_i[col], out_i[col]
    o = torch.arange(out_max, dtype=torch.int64, device=dev)[:, None]
    c2 = (2 * o + 1) * n_in  # 2 out * center
    inv = _f32(1.0) / (2 * n_out).to(_F32)
    lo = torch.minimum(torch.div((c2 - 5 * n_out).clamp(min=0), 2 * n_out,
                                 rounding_mode="floor"), n_in)
    hi = torch.minimum(torch.div(c2 + 7 * n_out, 2 * n_out, rounding_mode="floor"), n_in)
    return o, c2, lo, hi, n_out, inv


def _upscale_coeff_matrix(in_size, out_size, in_max: int, out_max: int) -> torch.Tensor:
    """Float32 [..., out_max, in_max] normalized lanczos coefficients of a
    growing size, each tap's argument ``x - center + 0.5`` taken from
    integers: ``((2x + 1) out - (2o + 1) in) * (1 / (2 out))``, an exact
    integer times the float32 reciprocal, and the window
    ``[trunc(center - 2.5), trunc(center + 3.5))`` in integers. At a 5.85x
    upscale the f32 ``center = (o + 0.5) * scale`` of
    :func:`resample_coeff_matrix` is off by ~3e-5 px, which moves a
    coefficient by up to ~90 units of 2^22 from Pillow's; this form stays
    within 2 (the lanczos fit's own error). Rows at or past ``out_size`` are
    zero; the weight sum adds the taps in index order, as K2 does."""
    o, c2, lo, hi, n_out, inv = _upscale_windows(in_size, out_size, out_max)
    x = torch.arange(in_max, dtype=torch.int64, device=c2.device)[None, :]
    arg = ((2 * x + 1) * n_out - c2).to(_F32) * inv
    w = _FILTERS["lanczos"](arg) * ((x >= lo) & (x < hi)).to(_F32)
    wsum = torch.zeros(w.shape[:-1], dtype=_F32, device=c2.device)
    for tap in range(in_max):
        wsum = wsum + w[..., tap]
    wsum = wsum[..., None]
    w = w / torch.where(wsum != 0.0, wsum, _f32(1.0))
    return w * (o < n_out).to(_F32)


#: taps of a growing size's window: hi - lo <= (12 out) / (2 out) = 6
UPSCALE_TAPS = 6


def upscale_tap_windows(in_size, out_size, out_max: int):
    """A growing size's tables by window, in the exact-argument form of
    :func:`_upscale_coeff_matrix` (the same integers, products, weight sum
    and quantisation, with no [out, in] matrix): int64 ``lo`` and ``hi``
    ``[..., out_max]`` (``hi == lo`` at or past ``out_size``) and the int32
    coefficients of taps ``lo .. lo + 5`` ``[..., out_max, UPSCALE_TAPS]``,
    zero from ``hi`` on. Scattered into ``[out_max, in]`` it equals
    :func:`build_coeffs_v3` wherever the size grows; K2's table stage
    (``csrc/fused_v3.cu``: v3_tables) writes these values."""
    o, c2, lo, hi, n_out, inv = _upscale_windows(in_size, out_size, out_max)
    hi = torch.where(o < n_out, hi, lo)
    x = lo + torch.arange(UPSCALE_TAPS, dtype=torch.int64, device=c2.device)
    arg = ((2 * x + 1) * n_out - c2).to(_F32) * inv
    w = _FILTERS["lanczos"](arg) * (x < hi).to(_F32)
    wsum = torch.zeros(w.shape[:-1], dtype=_F32, device=c2.device)
    for tap in range(UPSCALE_TAPS):  # index order; taps past hi add zero
        wsum = wsum + w[..., tap]
    w = w / torch.where(wsum != 0.0, wsum, _f32(1.0))[..., None]
    return lo[..., 0], hi[..., 0], quantize_coeffs(w)


def build_coeffs_v3(in_size, out_size, in_max: int, out_max: int) -> torch.Tensor:
    """int32 [..., out_max, in_max] lanczos tables as K2 (``csrc/fused_v3.cu``)
    builds them in a launch whose envelope exceeds the objects' padded
    extent: :func:`build_coeffs_traced` where the size shrinks or stays, and
    :func:`_upscale_coeff_matrix`'s exact-argument form where it grows."""
    traced = build_coeffs_traced(in_size, out_size, in_max, out_max)
    up = _grows(in_size, out_size)
    if not bool(up.any()):
        return traced
    upscaled = quantize_coeffs(_upscale_coeff_matrix(in_size, out_size, in_max, out_max))
    return torch.where(up[..., None, None], upscaled, traced)


# ----------------------- exact fixed-point resample -----------------------

def _clip8(ss: torch.Tensor) -> torch.Tensor:
    """Pillow clip8 of an exact float64 accumulator that carries +2^21:
    arithmetic ``>> 22`` clamped to [0, 255], as int32."""
    return (ss.to(torch.int64) >> PRECISION_BITS).clamp_(0, 255).to(torch.int32)


def resample_fixed(
    img: torch.Tensor, kh_i32: torch.Tensor, kv_i32: torch.Tensor
) -> torch.Tensor:
    """Two-pass fixed-point resample, bit-exact vs Pillow given its tables.

    img: [..., Hin_max, Win_max, C] holding uint8 values (any integer dtype).
    kh_i32: [..., Wout_max, Win_max]; kv_i32: [..., Hout_max, Hin_max].
    Leading dims broadcast. Returns int32 [..., Hout_max, Wout_max, C] of
    uint8 values.
    """
    f = torch.float64
    # horizontal pass first (Pillow order): tmp[h,o,c] = clip8(half + Σ_i kh[o,i] p[h,i,c])
    ss_h = torch.einsum("...hic,...oi->...hoc", img.to(f), kh_i32.to(f)) + _HALF
    tmp = _clip8(ss_h)
    ss_v = torch.einsum("...hwc,...oh->...owc", tmp.to(f), kv_i32.to(f)) + _HALF
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


def resize_f32(
    img: torch.Tensor,
    in_hw,
    out_hw,
    out_max_hw: Tuple[int, int],
    method: str = "lanczos",
) -> torch.Tensor:
    """Traced-size resample (port of JAX resize.py:464-486), batched.

    img: [..., Hm, Wm, C] holding uint8 values; in_hw = (in_h, in_w) and
    out_hw = (out_h, out_w): size tensors (or ints) of shape [...]. The
    tables come from the f32 table code (:func:`build_coeffs_traced`) and
    the resample is the exact float64 one, so CPU and CUDA agree bit for
    bit (JAX's traced resample is an f32 dot that may flip ±1). Where the
    output size equals the input size, Pillow's plain copy of the padded
    source is taken (chosen per item on the device, no host sync).
    Returns float32 [..., out_max_h, out_max_w, C]; live region
    [out_h, out_w], zeros beyond.
    """
    dev = img.device
    in_h, in_w, out_h, out_w = (
        torch.as_tensor(v, device=dev).to(torch.int64) for v in (*in_hw, *out_hw)
    )
    out_max_h, out_max_w = out_max_hw
    hm, wm, channels = img.shape[-3:]
    kh = build_coeffs_traced(in_w, out_w, wm, out_max_w, method)
    kv = build_coeffs_traced(in_h, out_h, hm, out_max_h, method)
    src = premultiply_rgba(img) if channels == 4 else img
    out = resample_fixed(src, kh, kv)
    if channels == 4:
        out = unpremultiply_rgba(out)
    copy_h, copy_w = min(hm, out_max_h), min(wm, out_max_w)
    passthrough = torch.zeros_like(out)
    passthrough[..., :copy_h, :copy_w, :] = img[..., :copy_h, :copy_w, :].to(torch.int32)
    same = (out_h == in_h) & (out_w == in_w)
    return torch.where(same[..., None, None, None], passthrough, out).to(torch.float32)


def resize_f32_shifted(
    img: torch.Tensor,
    in_hw,
    out_hw,
    out_offset_hw,
    out_max_hw: Tuple[int, int],
    method: str = "lanczos",
) -> torch.Tensor:
    """:func:`resize_f32` with the live output region starting at
    ``out_offset_hw`` = (off_y, off_x) (size tensors or ints of shape
    [...]) inside the [out_max_h, out_max_w] buffer (port of JAX
    resize.py:196-222). The shift is baked into the tables: row ``o`` of a
    table built with offset ``off`` equals row ``o - off`` of the unshifted
    table bit for bit, since ``o - off`` is an exact integer in f32. Pillow's
    identity shortcut is left to the caller (it needs a shifted copy).
    Returns float32 [..., out_max_h, out_max_w, C]."""
    dev = img.device
    in_h, in_w, out_h, out_w, off_y, off_x = (
        torch.as_tensor(v, device=dev).to(torch.int64)
        for v in (*in_hw, *out_hw, *out_offset_hw)
    )
    out_max_h, out_max_w = out_max_hw
    hm, wm, channels = img.shape[-3:]
    in_w, out_w, off_x = torch.broadcast_tensors(in_w, out_w, off_x)
    in_h, out_h, off_y = torch.broadcast_tensors(in_h, out_h, off_y)
    kh = build_coeffs_traced(in_w, out_w, wm, out_max_w, method, off_x)
    kv = build_coeffs_traced(in_h, out_h, hm, out_max_h, method, off_y)
    src = premultiply_rgba(img) if channels == 4 else img
    out = resample_fixed(src, kh, kv)
    if channels == 4:
        out = unpremultiply_rgba(out)
    return out.to(torch.float32)


def resize_u8(img: torch.Tensor, in_hw, out_hw, out_max_hw: Tuple[int, int],
              method: str = "lanczos") -> torch.Tensor:
    """uint8 form of :func:`resize_f32` (port of JAX resize.py:489-499)."""
    return resize_f32(img, in_hw, out_hw, out_max_hw, method).to(torch.uint8)


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
