"""The work model of the batched solid render and of its statistic, and the
peaks of the card, held with the benchmark so that a change to the program
cannot move the yardstick.

Copied from the program's ``ops/roofline.py`` (``solid_render_bytes_per_batch``,
``changed_pixels``, ``CARDS``) and ``ops/roofline_compute.py``
(``solid_render_compute_per_batch``, ``INT_MAC_PEAK``, ``LIMBS``), with
the same ground rule: the work is what the RESULT requires, from the
inputs (objects, boxes, sizes) and the pixels a placement changes, never
from how kernels split it. Pixel masks and tap counts come from the
benchmark's own Pillow reference (``bench_torch.reference``), computed on
the card in float64.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import reference

#: HBM bytes/s and L2 bytes by torch.cuda.get_device_name() (NVIDIA H100
#: datasheet; L2 of 50 MB as the card reports it)
CARDS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "l2_bytes": 50 << 20},
    "NVIDIA H100 PCIe": {"hbm_bytes_per_s": 2.0e12, "l2_bytes": 50 << 20},
    "NVIDIA H100 NVL": {"hbm_bytes_per_s": 3.9e12, "l2_bytes": 50 << 20},
}
#: int8 tensor-core multiply-adds per second, dense (half the datasheet's TOPS)
INT_MAC_PEAK = {
    "NVIDIA H100 80GB HBM3": 1979e12 / 2,
    "NVIDIA H100 PCIe": 1513e12 / 2,
    "NVIDIA H100 NVL": 1670.5e12 / 2,
}
#: int8 products per counted multiply-add: a 22-bit Pillow coefficient in three limbs
LIMBS = 3
CHANNELS = 4


def card(device_name: str) -> Optional[Tuple[float, float]]:
    """(HBM bytes/s, int8 multiply-adds/s) of a card, or None if unknown."""
    for name, peaks in CARDS.items():
        if device_name.strip().lower().startswith(name.lower()):
            return peaks["hbm_bytes_per_s"], INT_MAC_PEAK[name]
    return None


def bound_seconds(nbytes: float, macs: float, device_name: str) -> Optional[float]:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the multiply-adds on the int8 tensor cores."""
    peaks = card(device_name)
    if peaks is None:
        return None
    return max(nbytes / peaks[0], macs * LIMBS / peaks[1])


def table_taps(in_size: int, out_size: int) -> int:
    return int(np.count_nonzero(reference.coefficients(in_size, out_size)))


class RenderWork:
    """Work of a batched solid render over pools of box sets, per set.

    ``objects`` uint8 [N, ph, pw, 4] and ``obj_hw`` [N, 2] (h, w) are the
    shared objects; ``pool`` int [S, B, N, 4] the box sets; ``canvas_hw``
    the canvas. Resized alpha masks are cached by (object, size), so a pool
    of many canvases costs one resample per distinct size."""

    def __init__(self, objects: np.ndarray, obj_hw: np.ndarray, pool: np.ndarray,
                 canvas_hw: Tuple[int, int], device):
        self.objects, self.obj_hw = objects, np.asarray(obj_hw, np.int64)
        self.pool, self.canvas_hw, self.device = np.asarray(pool, np.int64), canvas_hw, device
        self._masks: Dict[tuple, torch.Tensor] = {}
        self._taps: Dict[tuple, int] = {}
        self._changed: Dict[int, int] = {}

    def _mask(self, k: int, oh: int, ow: int) -> torch.Tensor:
        key = (k, oh, ow)
        if key not in self._masks:
            h, w = (int(v) for v in self.obj_hw[k])
            obj = torch.from_numpy(np.ascontiguousarray(self.objects[k, :h, :w])).to(self.device)
            self._masks[key] = reference.resample(obj, (ow, oh))[..., 3] > 0
        return self._masks[key]

    def _tap(self, n_in: int, n_out: int) -> int:
        if (n_in, n_out) not in self._taps:
            self._taps[(n_in, n_out)] = table_taps(n_in, n_out)
        return self._taps[(n_in, n_out)]

    def changed_pixels(self, s: int) -> int:
        """Canvas pixels under a resized pixel of alpha > 0 of set ``s``."""
        if s not in self._changed:
            H, W = self.canvas_hw
            total = 0
            for canvas_boxes in self.pool[s]:
                mask = torch.zeros((H, W), dtype=torch.bool, device=self.device)
                for k, (x1, y1, x2, y2) in enumerate(canvas_boxes.tolist()):
                    if not (0 <= x1 < W and 0 <= y1 < H):
                        continue
                    m = self._mask(k, max(1, y2 - y1), max(1, x2 - x1))
                    h, w = min(m.shape[0], H - y1), min(m.shape[1], W - x1)
                    mask[y1:y1 + h, x1:x1 + w] |= m[:h, :w]
                total += int(mask.sum())
            self._changed[s] = total
        return self._changed[s]

    def object_bytes(self, s: int) -> int:
        """Each object placed in the set, its live pixels read once (4 B, shared objects)."""
        placed = np.zeros(self.obj_hw.shape[0], bool)
        H, W = self.canvas_hw
        for canvas_boxes in self.pool[s]:
            placed |= (canvas_boxes[:, 0] >= 0) & (canvas_boxes[:, 0] < W) & \
                      (canvas_boxes[:, 1] >= 0) & (canvas_boxes[:, 1] < H)
        live = [int(np.count_nonzero(self.objects[k, :h, :w, 3]))
                for k, (h, w) in enumerate(self.obj_hw.tolist())]
        return 4 * int(sum(n for n, p in zip(live, placed) if p))

    def macs(self, s: int) -> int:
        """Multiply-adds of the exact two-pass resample of every placement of
        set ``s`` that is not an identity copy."""
        H, W = self.canvas_hw
        total = 0
        for canvas_boxes in self.pool[s]:
            for k, (x1, y1, x2, y2) in enumerate(canvas_boxes.tolist()):
                ih, iw = (int(v) for v in self.obj_hw[k])
                oh, ow = max(1, y2 - y1), max(1, x2 - x1)
                if not (0 <= x1 < W and 0 <= y1 < H) or (oh, ow) == (ih, iw):
                    continue
                total += CHANNELS * (self._tap(iw, ow) * ih + self._tap(ih, oh) * ow)
        return total

    def render_bytes(self, prev: int, s: int) -> int:
        """Bytes of one reuse render of set ``s`` after set ``prev``: the
        previous render's changed pixels restored (4 B), this render's read
        and written (8 B), the placed objects read."""
        return 4 * self.changed_pixels(prev) + 8 * self.changed_pixels(s) + self.object_bytes(s)


def stat_bytes(batch: int, canvas_hw: Tuple[int, int]) -> int:
    """One read of each canvas's crop (4 B a pixel) and its float32 out."""
    return batch * (canvas_hw[0] * canvas_hw[1] * 4 + 4)
