# Port of image_transformation_tpu/ops/roofline_compute.py: the operations side of the roofline.
"""Compute-side roofline of the solid-render step on an NVIDIA H100.

:mod:`.roofline` holds the bytes a step must move; this module holds the
operations it must do, and the rates at which the card can do them, so
that a measured step time can be held against the least time the card
could take ("speed of light", SOL).

What is counted is the work the RESULT requires, from the inputs (object
sizes, boxes, canvas) alone: Pillow's fixed-point two-pass LANCZOS
resample of each placement that is not an identity copy, and one Pillow
alpha-over per pixel of each placement on the canvas. Nothing depends on
how a kernel splits that work (windows, tiles, launches, scratch), so the
count is a floor for any correct implementation, today's or a redesigned
one.

JAX's counter (``count_jaxpr_ops`` and ``_stage_counts``) is not ported.
It traces the TPU kernel's own helpers and counts how THAT kernel spends
its MXU and VPU instruction slots (limb dots, lane moves, table scaffolds): a
property of one implementation on one chip, not of the work.

The rates, and why the bound uses the faster one:

* ``INT_MAC_PEAK``: the fastest rate at which any unit of the card does
  the counted multiply-adds exactly, the int8 tensor cores at the
  datasheet's dense rate. A Pillow coefficient is an int32 of up to 22
  bits, so one counted multiply-add costs ``LIMBS`` = 3 int8 products
  (three 8-bit limbs, summed exactly in int32). A kernel that moves the
  resample onto the tensor cores must still read at most 100% of the
  bound, so the bound divides by this rate and not by a slower one.
* ``SCALAR_OPS_PEAK``: the float32 rate outside the tensor cores, the
  rate of today's kernels, which do every multiply-add and the whole
  alpha-over on the ALUs. Its time (``scalar_sol_ms``, two operations a
  multiply-add plus ``ALPHA_OVER_OPS`` an alpha-over) is a diagnostic:
  it is printed beside the bound and is never the bound.

The alpha-over (a divide and a clamp per channel) has no tensor-core
form; its operations enter only the diagnostic time, which leaves the
bound a floor.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .compose_kernels import _round_up, _static_window_extents, window_extents
from .resize import build_coeffs_host

#: int8 products per counted multiply-add: three 8-bit limbs of a Pillow
#: coefficient (22 bits of precision plus sign)
LIMBS = 3
#: integer operations of one Pillow alpha-over (csrc/pillow.cuh: 7
#: multiplies, 1 divide, ~22 adds and shifts)
ALPHA_OVER_OPS = 30
#: channels each resample tap multiplies (RGBA, premultiplied)
CHANNELS = 4

#: int8 tensor-core multiply-adds per second, dense (half the datasheet's
#: dense TOPS), by torch.cuda.get_device_name(). NVIDIA H100 Tensor Core
#: GPU datasheet: SXM5 1,979 TOPS, PCIe 1,513, NVL 1,670.5 (3,958 / 3,026 /
#: 3,341 with sparsity).
INT_MAC_PEAK = {
    "NVIDIA H100 80GB HBM3": 1979e12 / 2,  # H100 SXM5
    "NVIDIA H100 PCIe": 1513e12 / 2,
    "NVIDIA H100 NVL": 1670.5e12 / 2,
}
#: float32 operations per second outside the tensor cores (an FMA counts
#: two), same datasheet: SXM5 67 TFLOP/s, PCIe 51, NVL 60
SCALAR_OPS_PEAK = {
    "NVIDIA H100 80GB HBM3": 67e12,
    "NVIDIA H100 PCIe": 51e12,
    "NVIDIA H100 NVL": 60e12,
}


def lookup(table: dict, device_name: str):
    """``table``'s entry for a card name, exact or by prefix; None for an
    unknown card (callers then report null, never a guess)."""
    name = (device_name or "").strip()
    if name in table:
        return table[name]
    for key, val in table.items():
        if name and name.lower().startswith(key.lower()):
            return val
    return None


def realized_sizes(
    obj_hw: np.ndarray,
    boxes: np.ndarray,
    canvas_hw: Tuple[int, int],
    obj_pad_hw: Tuple[int, int],
    out_max_hw: Optional[Tuple[int, int]] = None,
    static_obj_hw: Optional[Sequence[Tuple[int, int]]] = None,
) -> Dict[str, np.ndarray]:
    """The placements' geometry as the solid render realizes it, on the
    host: ``in_h``, ``in_w``, ``out_h``, ``out_w`` (int64 [B, N]), ``valid``
    (the origin lies on the canvas; the render drops the rest) and ``same``
    (an identity copy, no resample). Target sizes clamp as
    ``compose_kernels._fused_v3_meta`` clamps them: at each object's own
    window with ``static_obj_hw`` (the pipelined step), else at the
    envelope's, so an oversized box renders a cropped scale."""
    boxes = np.asarray(boxes, np.int64)
    B, N = boxes.shape[:2]
    in_hw = np.broadcast_to(np.asarray(obj_hw, np.int64).reshape(-1, N, 2), (B, N, 2))
    mh_a = _round_up(int((out_max_hw or obj_pad_hw)[0]), 8)
    mw_a = _round_up(int((out_max_hw or obj_pad_hw)[1]), 128)
    if static_obj_hw is None:
        caps = np.array([window_extents((mh_a, mw_a))] * N, np.int64)
    else:
        caps = np.array(_static_window_extents(static_obj_hw, (mh_a, mw_a)), np.int64)
    x1, y1 = boxes[..., 0], boxes[..., 1]
    out_w = np.minimum(np.maximum(1, boxes[..., 2] - x1), caps[None, :, 1] - 128)
    out_h = np.minimum(np.maximum(1, boxes[..., 3] - y1), caps[None, :, 0] - 8)
    in_h, in_w = in_hw[..., 0], in_hw[..., 1]
    H, W = canvas_hw
    return dict(in_h=in_h, in_w=in_w, out_h=out_h, out_w=out_w,
                valid=(x1 >= 0) & (y1 >= 0) & (x1 < W) & (y1 < H),
                same=(out_h == in_h) & (out_w == in_w))


def table_taps(in_size: int, out_size: int, method: str = "lanczos") -> int:
    """Nonzero taps of Pillow's table resampling ``in_size`` to
    ``out_size`` (the host table, bit-exact vs Pillow; cached by size)."""
    return int(np.count_nonzero(
        build_coeffs_host(int(in_size), int(out_size), int(in_size), int(out_size), method)))


def resample_macs(kh: torch.Tensor, kv: torch.Tensor, in_h: torch.Tensor,
                  out_w: torch.Tensor, resampled: torch.Tensor) -> int:
    """Multiply-adds of the exact two-pass resample of the placements where
    ``resampled`` [B, N] is set, on the tables ``kh`` [B, N, out, in] and
    ``kv``: each nonzero table entry multiplies each channel once over the
    ``in_h`` source rows (H pass) or the ``out_w`` output columns (V pass).
    Building the tables is not counted."""
    nh = (kh != 0).sum(dim=(-1, -2))
    nv = (kv != 0).sum(dim=(-1, -2))
    return int((CHANNELS * (nh * in_h + nv * out_w) * resampled).sum())


def solid_render_compute_per_batch(
    obj_hw: np.ndarray,
    boxes: np.ndarray,
    canvas_hw: Tuple[int, int],
    obj_pad_hw: Tuple[int, int],
    static_obj_hw: Optional[Sequence[Tuple[int, int]]] = None,
    method: str = "lanczos",
) -> Dict[str, object]:
    """Operations one batched solid render (``boxes`` [B, N, 4] over the
    objects of sizes ``obj_hw`` [N, 2]) requires.

    Returns ``stages``: ``h_pass`` and ``v_pass``, the multiply-adds of
    the resample (:func:`resample_macs`' rule on the host tables the sizes
    give), and ``blend``, ``ALPHA_OVER_OPS`` per pixel of each valid
    placement's box on the canvas; ``int_macs`` (the two passes),
    ``scalar_ops`` (the blend) and ``total``, in operations with a
    multiply-add counted as two, as the datasheets count. Identity
    placements and placements whose origin lies off the canvas do no
    resample work (the render copies or drops them)."""
    g = realized_sizes(obj_hw, boxes, canvas_hw, obj_pad_hw, None, static_obj_hw)
    H, W = canvas_hw
    boxes = np.asarray(boxes, np.int64)
    x1, y1 = boxes[..., 0], boxes[..., 1]
    h_pass = v_pass = 0
    resampled = g["valid"] & ~g["same"]
    for b, k in zip(*np.nonzero(resampled)):
        in_h, in_w, out_h, out_w = (int(g[n][b, k]) for n in ("in_h", "in_w", "out_h", "out_w"))
        h_pass += CHANNELS * table_taps(in_w, out_w, method) * in_h
        v_pass += CHANNELS * table_taps(in_h, out_h, method) * out_w
    on_canvas = (np.clip(y1 + g["out_h"], 0, H) - np.clip(y1, 0, H)) * (
        np.clip(x1 + g["out_w"], 0, W) - np.clip(x1, 0, W))
    blend = ALPHA_OVER_OPS * int(on_canvas[g["valid"]].sum())
    return {"int_macs": h_pass + v_pass, "scalar_ops": blend,
            "total": 2 * (h_pass + v_pass) + blend,
            "stages": {"h_pass": h_pass, "v_pass": v_pass, "blend": blend}}


def int_mac_seconds(macs: float, device_name: str) -> Optional[float]:
    """Least time of ``macs`` counted multiply-adds on the card's int8
    tensor cores (``LIMBS`` products each); None for an unknown card."""
    peak = lookup(INT_MAC_PEAK, device_name)
    return macs * LIMBS / peak if peak else None


def scalar_seconds(ops: float, device_name: str) -> Optional[float]:
    """Time of ``ops`` operations at the card's float32 rate outside the
    tensor cores (diagnostic); None for an unknown card."""
    peak = lookup(SCALAR_OPS_PEAK, device_name)
    return ops / peak if peak else None


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else seconds * 1e3


def summarize_compute(
    work: Dict[str, object],
    batches_per_sec: float,
    device_name: str,
    hbm_bytes_per_batch: Optional[float] = None,
) -> Dict[str, object]:
    """Fold the work model into result fields: each unit's SOL time per
    batch, its share of the measured wall, and the binding unit.

    ``int_mac_*`` is the resample on the int8 tensor cores and ``hbm_*``
    the bytes of :mod:`.roofline`: the bound is the larger of the two, and
    ``binding_unit`` names it. ``scalar_*`` is the whole work on the
    float32 ALUs, a diagnostic that is never the bound.
    ``compute_sol_fraction`` is the serial sum of the bound's unit times
    over the wall: an upper bound on how much of the wall the model can
    explain with no overlap between units. Every peak, and every time and
    share built on it, is None on an unknown card."""
    if not (batches_per_sec > 0 and math.isfinite(batches_per_sec)):
        raise ValueError("batches_per_sec must be positive and finite")
    wall_s = 1.0 / batches_per_sec
    stages = work["stages"]
    t_mac = int_mac_seconds(work["int_macs"], device_name)
    t_scalar = scalar_seconds(work["total"], device_name)
    out: Dict[str, object] = {
        "model_work_per_batch": {k: int(work[k]) for k in ("int_macs", "scalar_ops", "total")},
        "int_mac_peak_macs_per_s": lookup(INT_MAC_PEAK, device_name),
        "int_mac_limbs": LIMBS,
        "scalar_peak_ops_per_s": lookup(SCALAR_OPS_PEAK, device_name),
        "wall_ms_per_batch": wall_s * 1e3,
        "int_mac_sol_ms": _ms(t_mac),
        "int_mac_utilization": None if t_mac is None else t_mac / wall_s,
        "scalar_sol_ms": _ms(t_scalar),
        "scalar_utilization": None if t_scalar is None else t_scalar / wall_s,
        "device_name": device_name,
    }
    if t_mac is not None and t_scalar is not None:
        out["stage_sol_ms"] = {
            name: {"int_mac": 0.0 if name == "blend" else _ms(int_mac_seconds(n, device_name)),
                   "scalar": _ms(scalar_seconds(n if name == "blend" else 2 * n, device_name))}
            for name, n in stages.items()
        }
    parts = [("int_mac", t_mac)]
    if hbm_bytes_per_batch is not None:
        from .roofline import hbm_peak_gbps

        peak_bw = hbm_peak_gbps(device_name)
        if peak_bw:
            t_hbm = hbm_bytes_per_batch / (peak_bw * 1e9)
            out["hbm_sol_ms"] = t_hbm * 1e3
            parts.append(("hbm", t_hbm))
    known = [(n, t) for n, t in parts if t is not None]
    if known:
        out["binding_unit"] = max(known, key=lambda p: p[1])[0]
        out["compute_sol_fraction"] = sum(t for _, t in known) / wall_s
    return out


__all__ = [
    "ALPHA_OVER_OPS",
    "INT_MAC_PEAK",
    "LIMBS",
    "SCALAR_OPS_PEAK",
    "int_mac_seconds",
    "realized_sizes",
    "resample_macs",
    "scalar_seconds",
    "solid_render_compute_per_batch",
    "summarize_compute",
    "table_taps",
]
