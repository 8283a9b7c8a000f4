# Port of image_transformation_tpu/ops/roofline.py: the bytes side of the roofline, on the H100.
"""Work model of the solid-render step and of each kernel, against the
peaks of the NVIDIA H100 it runs on.

It makes a throughput number checkable: the bytes a step must move over
the card's HBM rate (and, with :mod:`.roofline_compute`, the operations
it must do over the tensor cores' rate) is the least time the card could
take, and a measured time reads as a share of it.

The ground rule of every count here: it is the work the RESULT requires,
derived from the inputs (objects, boxes, sizes) and from the output
(which pixels a placement changes). It never depends on how the port's
kernels or programs split that work (windows, envelopes, tiles,
launches, scratch), so it is a floor for any correct implementation and
a share computed from it cannot read above 1. JAX's model counted the
TPU kernels' DMA windows instead; those terms are redefined here, by the
same names.

Two kinds of count:

* per kernel (``blend_bound``, ``k1_bound``, ``k2_bound``, ``k3_bound``;
  K2's launches alone ``k2_resample_bound``, ``k2_tables_bound``):
  what one kernel call's function requires on the arguments it is given,
  as ``bound`` folds it (the time, what bounds it, and whether the working
  set fits in L2, where a share is not an HBM share);
* per step (``solid_render_bytes_per_batch``): what one batched solid
  render requires, whatever program implements it, and
  ``expected_live_hbm_bytes``, the device memory the port's own step
  holds.

The geometry helpers ``window_extents``, ``fused_canvas_pad_hw`` and
``static_restore_windows`` (JAX's names) are the port's own
``compose_kernels`` functions.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import roofline_compute
from .compose_kernels import _V3_ENTRY, _V3_SCRATCH_BYTES, _META_COLS, _round_up, _v3_table_axes
from .compose_kernels import _static_window_extents as static_restore_windows
from .compose_kernels import fused_canvas_pad_hw, fused_compose_reference, fused_v3_reference
from .compose_kernels import window_extents
from .resize import PRECISION_BITS, build_coeffs_host, build_coeffs_traced

#: the card the port targets: bounds of work held on the CPU are its bounds
TARGET_CARD = "NVIDIA H100 80GB HBM3"
#: memory peaks by torch.cuda.get_device_name(), from NVIDIA's H100 Tensor
#: Core GPU datasheet (HBM bandwidth) and the Hopper architecture white paper
#: (L2 of 50 MB, 52,428,800 bytes as the card reports it)
CARDS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "l2_bytes": 50 << 20},  # SXM5
    "NVIDIA H100 PCIe": {"hbm_bytes_per_s": 2.0e12, "l2_bytes": 50 << 20},
    "NVIDIA H100 NVL": {"hbm_bytes_per_s": 3.9e12, "l2_bytes": 50 << 20},
}


def card_peaks(device_name: str) -> Optional[dict]:
    """The card's memory peaks, or None for an unknown card."""
    return roofline_compute.lookup(CARDS, device_name)


def hbm_peak_gbps(device_name: str) -> Optional[float]:
    """Peak HBM bandwidth (GB/s) of a card named as
    ``torch.cuda.get_device_name()`` gives it, or None if unknown (callers
    must then report utilization as null, not guess)."""
    peaks = card_peaks(device_name)
    return peaks["hbm_bytes_per_s"] / 1e9 if peaks else None


def _card(device_name: Optional[str]) -> str:
    if device_name is not None:
        return device_name
    return torch.cuda.get_device_name() if torch.cuda.is_available() else TARGET_CARD


# ------------------------------ per kernel ------------------------------

def bound(nbytes: float, macs: float = 0, scalar_ops: float = 0,
          device_name: Optional[str] = None) -> dict:
    """The least time the card could take for a call that must move
    ``nbytes`` and do ``macs`` resample multiply-adds: the larger of the
    bytes over the HBM rate and the multiply-adds on the int8 tensor cores
    (``roofline_compute.int_mac_seconds``), and which of the two it is.
    ``scalar_ms`` is the diagnostic time of the multiply-adds (two
    operations each) and ``scalar_ops`` alpha-over operations on the
    float32 ALUs; it is never the bound. ``l2_resident``: the bytes fit in
    the card's L2, so a repeated call may not reach HBM and its share is
    not an HBM share. The card is ``device_name``, by default the current
    CUDA card, or ``TARGET_CARD`` without one; raises for a card with no
    peaks."""
    name = _card(device_name)
    peaks = card_peaks(name)
    t_ops = roofline_compute.int_mac_seconds(macs, name)
    if peaks is None or t_ops is None:
        raise ValueError(f"no peaks for card {name!r}: add it to roofline.CARDS and "
                         "roofline_compute's tables, from its datasheet")
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_gbytes=nbytes / 1e9, bound_gmacs=macs / 1e9,
                scalar_ms=1e3 * roofline_compute.scalar_seconds(2 * macs + scalar_ops, name),
                l2_resident=bool(nbytes < peaks["l2_bytes"]), library_ms=None)


def placement_traffic(plane_shape, rects):
    """(covered source pixels, distinct plane pixels written) of placements
    ``rects`` = [(b, x, y, mh, mw), ...], cut at the plane [B, hp, wp]."""
    B, hp, wp = plane_shape
    mask = torch.zeros((B, hp, wp), dtype=torch.bool)
    covered = 0
    for b, x, y, mh, mw in rects:
        x0, y0, x1, y1 = max(x, 0), max(y, 0), min(x + mw, wp), min(y + mh, hp)
        if x1 > x0 and y1 > y0:
            covered += (y1 - y0) * (x1 - x0)
            mask[b, y0:y1, x0:x1] = True
    return covered, int(mask.sum())


def blend_bound(plane_shape, src, meta, blends=True) -> dict:
    """Bound of one K4 launch on ``meta`` as the launch takes it (any
    columns zeroed), counting what these inputs need: each pixel of a valid
    placement's live box (the bounding box of its source's nonzero pixels;
    the producers zero a source outside its resized box) read once (4 B)
    where it lies on the plane [B, hp, wp]; each plane pixel under a source
    pixel of alpha > 0 read and written once (8 B; Pillow's alpha-over leaves
    the plane as it is under alpha 0); the meta; and, where the launch
    blends, an alpha-over for each source pixel of alpha > 0 on the plane.
    ``src`` is packed i32 [B, N, mh, mw] or planar u8 [B, N, 4, mh, mw]."""
    B, hp, wp = plane_shape
    if src.dim() == 5:
        alpha, live = src[:, :, 3] > 0, (src != 0).any(dim=2)
    else:
        alpha, live = ((src >> 24) & 255) != 0, src != 0
    rows, cols = live.any(-1), live.any(-2)
    r = torch.arange(rows.shape[-1], device=src.device)
    c = torch.arange(cols.shape[-1], device=src.device)
    # first and one-past-last live row and column (an empty source: first > last)
    extents = torch.stack([torch.where(rows, r, rows.shape[-1]).amin(-1),
                           torch.where(rows, r + 1, 0).amax(-1),
                           torch.where(cols, c, cols.shape[-1]).amin(-1),
                           torch.where(cols, c + 1, 0).amax(-1)], -1).tolist()
    written = torch.zeros((B, hp, wp), dtype=torch.bool, device=src.device)
    blended = torch.zeros((), dtype=torch.int64, device=src.device)
    read = 0
    for b, rows_b in enumerate(meta.tolist()):
        for k, (ws_x, ws_y, dx, dy, _, valid) in enumerate(rows_b):
            r0, r1, c0, c1 = extents[b][k]
            x, y = ws_x + dx, ws_y + dy
            x0, y0 = max(x + c0, 0), max(y + r0, 0)
            x1, y1 = min(x + c1, wp), min(y + r1, hp)
            if valid <= 0 or x1 <= x0 or y1 <= y0:
                continue
            read += (x1 - x0) * (y1 - y0)
            a = alpha[b, k, y0 - y:y1 - y, x0 - x:x1 - x]
            written[b, y0:y1, x0:x1] |= a
            blended += a.sum()
    return bound(4 * read + 8 * int(written.sum()) + 4 * meta.numel(), 0,
                 roofline_compute.ALPHA_OVER_OPS * int(blended) if blends else 0)


def alpha_pixels(plane) -> int:
    """Pixels of alpha > 0 in a packed i32 [B, h, w] or u8 [B, h, w, 4]
    plane. Composed onto a transparent plane, they are the pixels some
    placement changes: Pillow's alpha-over leaves a pixel as it is under
    alpha 0."""
    if plane.dim() == 3:
        return int((((plane >> 24) & 255) != 0).sum())
    return int((plane[..., 3] > 0).sum())


def k1_bound(canvas, objects, kh, kv, boxes, flags) -> dict:
    """Bound of one K1 launch, counting what these inputs need: the objects,
    boxes and flags read; of the tables, the rows of each resampled
    placement's box (its size cut at the envelope); each canvas pixel
    under a resampled pixel of alpha > 0 read and written (the plain
    version composed onto a transparent canvas marks them); the resample's
    multiply-adds and an alpha-over per pixel of each live box on the
    canvas."""
    bx = boxes.to(torch.int64)
    out_w = (bx[..., 2] - bx[..., 0]).clamp(min=1, max=kh.shape[2])
    out_h = (bx[..., 3] - bx[..., 1]).clamp(min=1, max=kv.shape[2])
    live = (flags & 1) > 0
    resampled = (live & ((flags & 2) == 0)).to(torch.int64)
    live_h, sizes = live.tolist(), torch.stack([out_h, out_w], -1).tolist()
    rects = [(b, x, y, *sizes[b][k]) for b, row in enumerate(bx[..., :2].tolist())
             for k, (x, y) in enumerate(row) if live_h[b][k]]
    covered, _ = placement_traffic(canvas.shape[:3], rects)
    written = alpha_pixels(fused_compose_reference(torch.zeros_like(canvas), objects,
                                                   kh, kv, boxes, flags))
    tables = 4 * int(((out_w * kh.shape[3] + out_h * kv.shape[3]) * resampled).sum())
    nbytes = tables + sum(t.numel() * t.element_size() for t in (objects, boxes, flags))
    in_h = (kv != 0).any(dim=-2).sum(dim=-1)  # source rows that carry weight
    macs = roofline_compute.resample_macs(kh, kv, in_h, out_w, resampled)
    return bound(nbytes + 8 * written, macs, roofline_compute.ALPHA_OVER_OPS * covered)


def k2_bound(plane, objs_p, meta, out_max_hw) -> dict:
    """Bound of one K2 launch: its objects and meta read, each plane pixel
    under a resized pixel of alpha > 0 read and written (the plain version
    composed onto a transparent plane marks them), the resample's
    multiply-adds on the tables its sizes give (built here with the plain
    f32 table code) and an alpha-over per pixel of each placement on the
    plane."""
    m = meta.to(torch.int64)
    ph, pw = objs_p.shape[3], objs_p.shape[4]
    mh, mw = out_max_hw
    in_h, in_w = m[..., 6].clamp(0, ph), m[..., 7].clamp(0, pw)
    out_h, out_w = m[..., 8].clamp(0, mh), m[..., 9].clamp(0, mw)
    resampled = ((m[..., 5] > 0) & (m[..., 4] == 0)).to(torch.int64)
    macs = roofline_compute.resample_macs(build_coeffs_traced(in_w, out_w, pw, mw),
                                          build_coeffs_traced(in_h, out_h, ph, mh),
                                          in_h, out_w, resampled)
    sizes = torch.stack([out_h, out_w], -1).tolist()
    rects = [(b, ws_x + dx, ws_y + dy, *sizes[b][k])
             for b, rows in enumerate(m.tolist())
             for k, (ws_x, ws_y, dx, dy, _, valid, *_) in enumerate(rows) if valid > 0]
    covered, _ = placement_traffic(plane.shape, rects)
    written = alpha_pixels(fused_v3_reference(torch.zeros_like(plane), objs_p, meta,
                                              out_max_hw))
    nbytes = objs_p.numel() + 4 * meta.numel() + 8 * written
    return bound(nbytes, macs, roofline_compute.ALPHA_OVER_OPS * covered)


def k2_resample_bound(objs_p, meta, out_max_hw) -> dict:
    """Bound of K2's resample launch alone: its objects and meta read, each
    valid placement's resized pixels written (4 B each, the scratch the
    blend reads) and the resample's multiply-adds, as :func:`k2_bound`
    counts them."""
    m = meta.to(torch.int64)
    ph, pw = objs_p.shape[3], objs_p.shape[4]
    mh, mw = out_max_hw
    in_h, in_w = m[..., 6].clamp(0, ph), m[..., 7].clamp(0, pw)
    out_h, out_w = m[..., 8].clamp(0, mh), m[..., 9].clamp(0, mw)
    valid = (m[..., 5] > 0).to(torch.int64)
    resampled = valid * (m[..., 4] == 0).to(torch.int64)
    macs = roofline_compute.resample_macs(build_coeffs_traced(in_w, out_w, pw, mw),
                                          build_coeffs_traced(in_h, out_h, ph, mh),
                                          in_h, out_w, resampled)
    written = int((out_h * out_w * valid).sum())
    return bound(objs_p.numel() + 4 * meta.numel() + 4 * written, macs)


def k2_tables_bound(meta, obj_pad_hw, out_max_hw) -> dict:
    """Bound of K2's table stage (a mixed launch's first): its meta read and
    each entry the resample's tiles read written, 32 B a growing axis's
    output position (``compose_kernels._v3_table_axes``)."""
    entries = sum(int(w.sum()) for _, _, w in _v3_table_axes(meta, obj_pad_hw, out_max_hw))
    return bound(4 * meta.numel() + 4 * _V3_ENTRY * entries)


def k3_bound(plane, origins, extents) -> dict:
    """Bound of one K3 launch: each pixel of the union of a canvas's windows
    written once (4 B), the origins read; with the windows' summed pixels
    and that union (``summed_px``, ``union_px``). K3's function is to fill
    the windows it is given, so their union is its work; which windows a
    step must restore is the step's count (``solid_render_bytes_per_batch``)."""
    rects = [(b, x, y, *extents[k]) for b, row in enumerate(origins.tolist())
             for k, (x, y) in enumerate(row)]
    summed, union = placement_traffic(plane.shape, rects)
    return dict(bound(4 * union + 4 * origins.numel()), summed_px=summed, union_px=union)


def k4_scan_bytes(plane_shape, src, meta) -> int:
    """Source bytes K4's bounds launch reads: every pixel (4 B, packed or
    four planes) of each valid placement's envelope that lands on the plane
    [B, hp, wp] (rounded up to its 16-byte loads). Not a bound: what K4
    reads because JAX's signature hides the live boxes."""
    B, hp, wp = plane_shape
    mh, mw = src.shape[-2:]
    q = 16 if src.dim() == 5 else 4  # pixels per 16-byte load (of each plane)
    q = q if mw % q == 0 else 1
    total = 0
    for rows in meta.tolist():
        for ws_x, ws_y, dx, dy, _, valid in rows:
            x, y = ws_x + dx, ws_y + dy
            r = min(mh, hp - y) - max(0, -y)
            c0, c1 = max(0, -x), min(mw, wp - x)
            if valid > 0 and r > 0 and c1 > c0:
                total += 4 * r * q * (-(-c1 // q) - c0 // q)
    return total


# ------------------------------- per step -------------------------------

def _band(table: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(idx [out, T], weights [out, T] float64) of an int32 [out, in]
    table: each row's entries from its first to its last nonzero one,
    padded with zero weights."""
    nz = table != 0
    has = nz.any(1)
    first = np.where(has, nz.argmax(1), 0)
    width = np.where(has, table.shape[1] - nz[:, ::-1].argmax(1) - first, 0)
    t = np.arange(max(1, int(width.max())))
    idx = np.minimum(first[:, None] + t, table.shape[1] - 1)
    w = np.where(t < width[:, None], np.take_along_axis(table, idx, 1), 0)
    return idx, w.astype(np.float64)


def _clip8(ss: np.ndarray) -> np.ndarray:
    """Pillow's clip8 of an exact accumulator: ``(ss + 2^21) >> 22`` in [0, 255]."""
    return np.clip((ss + (1 << (PRECISION_BITS - 1))).astype(np.int64) >> PRECISION_BITS, 0, 255)


def resized_alpha(alpha: np.ndarray, kh: np.ndarray, kv: np.ndarray) -> np.ndarray:
    """Pillow's two-pass fixed-point resample of one u8 channel [in_h, in_w]
    by the int32 tables ``kh`` [out_w, in_w] and ``kv`` [out_h, in_h]: int64
    [out_h, out_w]. Each pass walks only its rows' tap windows; the float64
    sums are exact (products below 2^31, a few hundred a sum). The alpha of
    a premultiplied RGBA resample is this channel's resample."""
    ih, wh = _band(kh)
    tmp = _clip8((alpha.astype(np.float64)[:, ih] * wh).sum(-1))  # [in_h, out_w]
    iv, wv = _band(kv)
    return _clip8((tmp[iv].astype(np.float64) * wv[..., None]).sum(1))


def changed_pixels(objects: np.ndarray, boxes: np.ndarray, canvas_hw: Tuple[int, int],
                   geometry: Dict[str, np.ndarray], method: str = "lanczos") -> np.ndarray:
    """Canvas pixels some placement changes, per canvas (int64 [B]): those
    under a resized pixel of alpha > 0 of a valid placement (Pillow's
    alpha-over leaves a pixel as it is under alpha 0), cut at the canvas.
    Resized with the host tables, bit-exact vs Pillow; ``geometry`` is
    ``roofline_compute.realized_sizes`` of the boxes."""
    H, W = canvas_hw
    boxes = np.asarray(boxes, np.int64)
    out = np.zeros(boxes.shape[0], np.int64)
    resized: Dict[tuple, np.ndarray] = {}
    for b in range(boxes.shape[0]):
        mask = np.zeros((H, W), bool)
        for k in np.nonzero(geometry["valid"][b])[0]:
            ih, iw, oh, ow = (int(geometry[n][b, k]) for n in ("in_h", "in_w", "out_h", "out_w"))
            key = (int(k), ih, iw, oh, ow)
            if key not in resized:
                alpha = objects[k, :ih, :iw, 3]
                if not geometry["same"][b, k]:
                    alpha = resized_alpha(alpha, build_coeffs_host(iw, ow, iw, ow, method),
                                          build_coeffs_host(ih, oh, ih, oh, method))
                resized[key] = alpha > 0
            x, y = int(boxes[b, k, 0]), int(boxes[b, k, 1])
            mask[y:y + oh, x:x + ow] |= resized[key][:H - y, :W - x]
        out[b] = int(mask.sum())
    return out


def solid_render_bytes_per_batch(
    batch: int,
    n_objects: int,
    canvas_hw: Tuple[int, int],
    obj_pad_hw: Tuple[int, int],
    out_max_hw: Optional[Tuple[int, int]] = None,
    static_obj_hw: Optional[Sequence[Tuple[int, int]]] = None,
    shared_objs: bool = True,
    reuse: bool = True,
    stat: str = "fence",
    *,
    boxes: np.ndarray,
    objects,
) -> Dict[str, float]:
    """HBM bytes one batched solid render (``parallel/sweep.py``'s step)
    requires, by term, whatever program implements it.

    ``boxes`` int [B, N, 4] are the placements; ``objects`` the bundle's
    arrays (``core.bundle.BundleArrays``: u8 ``objects`` [N, ph, pw, 4],
    ``obj_hw`` [N, 2]); ``batch`` and ``n_objects`` must be their B and N.
    Sizes are those the render realizes (``roofline_compute.realized_sizes``:
    clamped to the windows ``static_obj_hw`` or the envelope give, origins
    off the canvas dropped). Terms, in bytes:

    * ``restore_write_bytes``: with ``reuse``, each canvas pixel that the
      previous render changed (under a resized pixel of alpha > 0) written
      once (4 B). In a loop that renders the same boxes every step (the
      bench loop) the previous render's pixels are this render's, and
      that is the assumption here. A fresh render (``reuse=False``)
      writes every pixel of the ``h x w`` crop once, not the padded plane.
    * ``window_io_bytes``: each canvas pixel under a resized pixel of
      alpha > 0 read and written once (8 B).
    * ``object_read_bytes``: each placed object's live pixels (alpha > 0;
      4 B, the four planes) read once when ``shared_objs``, once per
      canvas that places it when not.
    * ``stat_read_bytes``: the fence reads 512 B per canvas (``stat``
      "fence"); "luma" reads the crop.
    * ``total_bytes``: their sum.

    The restore and the compose count as two passes over a changed pixel,
    as the step's contract (restore the plane, then compose onto it) has
    them; one pass that did both would need 4 B a changed pixel, not 12.
    """
    objs = np.asarray(objects.objects)
    obj_hw = np.asarray(objects.obj_hw)
    boxes = np.asarray(boxes, np.int64)
    B, N = int(batch), int(n_objects)
    if boxes.shape[:2] != (B, N) or objs.shape[0] != N:
        raise ValueError(f"boxes {boxes.shape} and {objs.shape[0]} objects for "
                         f"batch {B} x {N} objects")
    if stat not in ("fence", "luma"):
        raise ValueError(f"stat must be 'fence' or 'luma', got {stat!r}")
    H, W = canvas_hw
    g = roofline_compute.realized_sizes(obj_hw, boxes, canvas_hw, obj_pad_hw, out_max_hw,
                                        static_obj_hw)
    written = float(changed_pixels(objs, boxes, canvas_hw, g).sum())
    restore = 4 * written if reuse else 4.0 * B * H * W
    live = np.array([np.count_nonzero(objs[k, :h, :w, 3]) for k, (h, w) in enumerate(obj_hw)])
    placed = g["valid"].any(0) if shared_objs else g["valid"].sum(0)
    objects_read = 4.0 * float((live * placed).sum())
    stat_bytes = float(B) * (128 * 4 if stat == "fence" else H * W * 4)
    window_io = 8 * written
    return {
        "restore_write_bytes": restore,
        "window_io_bytes": window_io,
        "object_read_bytes": objects_read,
        "stat_read_bytes": stat_bytes,
        "total_bytes": restore + window_io + objects_read + stat_bytes,
    }


def expected_live_hbm_bytes(
    batch: int,
    n_objects: int,
    canvas_hw: Tuple[int, int],
    obj_pad_hw: Tuple[int, int],
    out_max_hw: Optional[Tuple[int, int]] = None,
    shared_objs: bool = True,
) -> Dict[str, float]:
    """Device memory the port's solid-render step holds at its peak
    (``parallel/sweep.py:make_solid_render_step``): the number to hold
    against the card's 80 GB when a batch size is chosen.

    The first (fresh) render allocates the packed plane with
    ``torch.full``; each later render restores (K3) and composes (K2) IN
    PLACE on it, so one plane is live (JAX's step holds two across its
    donation swap). Beside it: the planar object copy (one, or one per
    canvas without ``shared_objs``), K2's resample scratch (``res``, at
    most ``_V3_SCRATCH_BYTES``, 1 GiB: the wrapper walks larger batches in
    chunks), K2's meta and K3's window origins."""
    B, N = int(batch), int(n_objects)
    ph_a, pw_a = _round_up(obj_pad_hw[0], 8), _round_up(obj_pad_hw[1], 128)
    mh_a, mw_a = (ph_a, pw_a) if out_max_hw is None else (
        _round_up(out_max_hw[0], 8), _round_up(out_max_hw[1], 128))
    hp, wp = fused_canvas_pad_hw(canvas_hw, (mh_a, mw_a))
    plane = float(B) * hp * wp * 4
    objects = 4.0 * ph_a * pw_a * N * (1 if shared_objs else B)
    per_canvas = N * 4 * mh_a * mw_a
    scratch = float(max(1, min(B, _V3_SCRATCH_BYTES // per_canvas)) * per_canvas)
    meta = 4.0 * B * N * (_META_COLS + 2)
    return {
        "plane_bytes": plane,
        "planes_live": 1,
        "object_bytes": objects,
        "scratch_bytes": scratch,
        "meta_bytes": meta,
        "total_bytes": plane + objects + scratch + meta,
    }


def summarize(
    bytes_per_batch: Dict[str, float],
    batches_per_sec: float,
    device_name: str,
) -> Dict[str, object]:
    """Fold the model into result fields: achieved GB/s, the card's peak
    and the HBM utilization. The utilization is null when the card is
    unknown (no peak is guessed) or when ``total_bytes`` fits in the
    card's L2 (a repeated step may not reach HBM); ``note`` says which."""
    total = bytes_per_batch["total_bytes"]
    achieved = total * batches_per_sec / 1e9
    peaks = card_peaks(device_name)
    if peaks is None:
        note = f"no peaks for card {device_name!r}: utilization not computed"
    elif total < peaks["l2_bytes"]:
        note = (f"{total:.0f} bytes fit in the {peaks['l2_bytes']}-byte L2: "
                "not an HBM share")
    else:
        note = None
    peak = peaks["hbm_bytes_per_s"] / 1e9 if peaks else None
    return {
        "model_bytes_per_batch": {k: round(v) for k, v in bytes_per_batch.items()},
        "achieved_gbps": achieved,
        "hbm_peak_gbps": peak,
        "hbm_utilization": achieved / peak if note is None else None,
        "device_name": device_name,
        "note": note,
    }


__all__ = [
    "CARDS",
    "TARGET_CARD",
    "alpha_pixels",
    "blend_bound",
    "bound",
    "card_peaks",
    "changed_pixels",
    "expected_live_hbm_bytes",
    "fused_canvas_pad_hw",
    "hbm_peak_gbps",
    "k1_bound",
    "k2_bound",
    "k3_bound",
    "k4_scan_bytes",
    "placement_traffic",
    "resized_alpha",
    "solid_render_bytes_per_batch",
    "static_restore_windows",
    "summarize",
    "window_extents",
]
