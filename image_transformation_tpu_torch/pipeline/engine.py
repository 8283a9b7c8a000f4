"""ComposeEngine: device-resident compose session for the iterate loop.

Port of image_transformation_tpu/pipeline/engine.py. The padded object
tensor and the base canvas are uploaded once per run; each compose ships
only per-placement metadata (Pillow-exact int32 coefficient tables, boxes,
flags) and runs K1 (ops/compose_kernels.py). On a CUDA device every
compose launches the hand-written kernel; on a CPU device the same wrapper
runs its plain PyTorch version. Both are bit-exact vs PIL.

K1 updates a canvas in place, so :meth:`ComposeEngine.compose` composes
into a clone of the base canvas and never writes into the base itself.
"""

from __future__ import annotations

import collections
from typing import Dict, List

import numpy as np
import torch

from ..core.bundle import BundleArrays
from ..ops.compose_kernels import fused_compose, fused_tables_prep

# LRU bounds of the per-call input cache (entries, device bytes)
_CACHE_MAX_ENTRIES = 64
_CACHE_MAX_BYTES = 256 << 20

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ComposeEngine:
    def __init__(
        self,
        arrays: BundleArrays,
        canvas_u8,
        device: torch.device,
    ):
        self.arrays = arrays
        self.device = torch.device(device)
        if not torch.is_tensor(canvas_u8):
            canvas_u8 = torch.from_numpy(np.array(canvas_u8, np.uint8))
        self.canvas_dev = canvas_u8.to(self.device, torch.uint8)
        self.objs_dev = torch.from_numpy(np.ascontiguousarray(arrays.objects)).to(
            self.device
        )
        self.pad_h = arrays.objects.shape[1]
        self.pad_w = arrays.objects.shape[2]
        # The flex solver never upscales, so resized buffers (and the paste
        # halo) only need the object pad envelope, not the canvas.
        self.out_max_h = self.pad_h
        self.out_max_w = self.pad_w
        self._id_to_idx = {
            int(oid): k for k, oid in enumerate(arrays.object_ids) if oid >= 0
        }
        # Opaque base canvas => every composed pixel's alpha is exactly 255
        # (PIL alpha_composite identity), so readers may transfer RGB only.
        canvas_np = np.asarray(self.canvas_dev.cpu())
        self.opaque_output = bool(
            canvas_np.ndim == 3
            and canvas_np.shape[-1] == 4
            and bool((canvas_np[..., 3] == 255).all())
        )
        # Per-call input cache: iterate loops re-solve similar layouts, so
        # identical (object, box) signatures skip rebuilding and uploading
        # the coefficient tables. LRU, bounded by entry count AND bytes.
        self._call_cache: "collections.OrderedDict" = collections.OrderedDict()
        self._cache_bytes = 0
        self._perm_cache: dict = {}

    def _cache_get(self, signature):
        entry = self._call_cache.get(signature)
        if entry is None:
            return None
        self._call_cache.move_to_end(signature)
        return entry[0]

    def _cache_put(self, signature, value) -> None:
        """Insert with LRU eviction on entry count and device bytes."""
        nbytes = sum(_nbytes(a) for a in value)
        self._call_cache[signature] = (value, nbytes)
        self._call_cache.move_to_end(signature)
        self._cache_bytes += nbytes
        while len(self._call_cache) > 1 and (
            len(self._call_cache) > _CACHE_MAX_ENTRIES
            or self._cache_bytes > _CACHE_MAX_BYTES
        ):
            old_sig, (_, old_nb) = next(iter(self._call_cache.items()))
            if old_sig == signature:
                break  # never evict the entry just inserted
            self._call_cache.pop(old_sig)
            self._cache_bytes -= old_nb

    def _kernel_args(self, live: List[Dict], signature):
        """(objects [1, N, ph, pw, 4], kh, kv, boxes, flags) on the device,
        cached per signature; gathered object planes are cached per
        object order (signatures share it, only boxes differ)."""
        cached = self._cache_get(signature)
        if cached is not None:
            return cached
        n = len(live)
        perm = np.zeros((n,), np.int64)
        boxes = np.zeros((n, 4), np.int64)
        obj_hw = np.zeros((n, 2), np.int64)
        for k, p in enumerate(live):
            idx = self._id_to_idx[int(p["object_id"])]
            perm[k] = idx
            boxes[k] = tuple(int(v) for v in p["box"])
            obj_hw[k] = tuple(int(v) for v in self.arrays.obj_hw[idx])
        kh, kv, boxes_i32, flags = fused_tables_prep(
            obj_hw[None], boxes[None],
            (self.canvas_dev.shape[0], self.canvas_dev.shape[1]),
            (self.pad_h, self.pad_w),
            (self.out_max_h, self.out_max_w),
        )
        perm_key = tuple(int(v) for v in perm)
        objs_sel = self._perm_cache.get(perm_key)
        if objs_sel is None:
            objs_sel = self.objs_dev[torch.from_numpy(perm).to(self.device)][None]
            if len(self._perm_cache) < 16:
                self._perm_cache[perm_key] = objs_sel
        dev = self.device
        cached = (
            objs_sel,
            *(torch.from_numpy(a).to(dev) for a in (kh, kv, boxes_i32, flags)),
        )
        self._cache_put(signature, cached)
        return cached

    def compose(self, placements: List[Dict]) -> torch.Tensor:
        """Compose placements (list order = z-order) onto a copy of the base
        canvas.

        Unknown object ids are skipped, matching the reference compositor.
        Returns a new device tensor (uint8 [H, W, 4]); callers move it to
        the host at artifact-save time. Bit-exact vs PIL.
        """
        live = self.validate_placements(placements)
        out = self.canvas_dev.clone()
        if not live:
            return out
        signature = tuple(
            (int(p["object_id"]), tuple(int(v) for v in p["box"])) for p in live
        )
        objs, kh, kv, boxes, flags = self._kernel_args(live, signature)
        fused_compose(out[None], objs, kh, kv, boxes, flags)
        return out

    def validate_placements(self, placements: List[Dict]) -> List[Dict]:
        """Drop unknown object ids (reference-compositor semantics) and
        raise on envelope violations."""
        live = [p for p in placements if int(p["object_id"]) in self._id_to_idx]
        self._check_envelope(live)
        return live

    def _check_envelope(self, live: List[Dict]) -> None:
        for p in live:
            x1, y1, x2, y2 = (int(v) for v in p["box"])
            w, h = max(1, x2 - x1), max(1, y2 - y1)
            if w > self.out_max_w or h > self.out_max_h:
                raise ValueError(
                    f"placement box {w}x{h} exceeds the downscale-only "
                    f"envelope {self.out_max_w}x{self.out_max_h}; use "
                    "ops.compose.composite_exact for upscaling placements"
                )
