# Copy of image_transformation_tpu/core/bundle.py (host-only), plus bundle_arrays_from_numpy.
"""Bundle I/O: the data contract between upstream segmentation and layout.

A bundle directory holds ``background.png`` (RGBA, original size),
``results.json`` (object metadata) and ``objects/*.png`` (RGBA cutouts) —
see SURVEY.md §2.4 and reference/compositor.py:25-35,
reference/agentic/utils/loaders.py:14-52.

Two views are provided:

- :class:`Bundle` — host-side metadata + PIL images (the PIL-compatible
  surface the shims and orchestrator use);
- :class:`BundleArrays` — the device view: one zero-padded uint8 object tensor
  ``[N, Hmax, Wmax, 4]`` with per-object (h, w) sizes, ready for the jitted
  compose path and batchable across bundles by padding to a common
  (N, Hmax, Wmax).

Decode stays on host (PNG codecs are not a device problem); everything after
ingest is arrays.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image


@dataclass
class ObjectMeta:
    object_id: int
    label: str
    filename: str
    width: int
    height: int
    bounding_box: Tuple[float, float, float, float]
    per_label_number: int = 0
    confidence_score: float = 0.0


@dataclass
class Bundle:
    """Host view of a segmentation bundle."""

    root: Path
    objects: Dict[int, Image.Image]
    meta: Dict[int, ObjectMeta]
    background: Image.Image
    items: List[dict] = field(default_factory=list)

    @property
    def results_json_path(self) -> Path:
        return self.root / "results.json"

    @property
    def background_path(self) -> Path:
        return self.root / "background.png"

    @property
    def objects_dir(self) -> Path:
        return self.root / "objects"

    def object_ids(self) -> List[int]:
        return sorted(self.meta)

    def id_to_label(self) -> Dict[int, str]:
        return {oid: m.label.strip() for oid, m in self.meta.items()}

    def sizes(self) -> Dict[int, Tuple[int, int]]:
        """object_id -> (width, height), the solver's SizeMap."""
        return {oid: (m.width, m.height) for oid, m in self.meta.items()}

    def to_arrays(
        self,
        n_max: Optional[int] = None,
        pad_hw: Optional[Tuple[int, int]] = None,
        order: Optional[List[int]] = None,
    ) -> "BundleArrays":
        ids = order if order is not None else self.object_ids()
        n = n_max if n_max is not None else len(ids)
        if len(ids) > n:
            raise ValueError(f"bundle has {len(ids)} objects > n_max={n}")
        if pad_hw is None:
            pad_h = max((m.height for m in self.meta.values()), default=1)
            pad_w = max((m.width for m in self.meta.values()), default=1)
        else:
            pad_h, pad_w = pad_hw
        if pad_h * pad_w > (1 << 28):
            # the padded envelope is the CROSS product of per-object max
            # height and max width, so two extreme-aspect cutouts (1xN and
            # Nx1) can each pass the per-image pixel cap yet demand an
            # astronomically large batch tensor — fail with the cause
            # instead of an opaque MemoryError/OOM-kill mid-allocation
            raise ValueError(
                f"padded object envelope {pad_h}x{pad_w} exceeds the "
                f"2^28-pixel cap; bundle objects' aspect ratios are too "
                f"extreme to batch into one padded tensor"
            )
        objs = np.zeros((n, pad_h, pad_w, 4), np.uint8)
        hw = np.zeros((n, 2), np.int32)
        oids = np.full((n,), -1, np.int32)
        for k, oid in enumerate(ids):
            arr = np.asarray(self.objects[oid])
            h, w = arr.shape[:2]
            if h > pad_h or w > pad_w:
                raise ValueError(
                    f"object {oid} ({h}x{w}) exceeds pad_hw ({pad_h}x{pad_w})"
                )
            objs[k, :h, :w] = arr
            hw[k] = (h, w)
            oids[k] = oid
        return BundleArrays(objects=objs, obj_hw=hw, object_ids=oids, n_valid=len(ids))


@dataclass
class BundleArrays:
    """Device-ready padded view of a bundle's cutouts."""

    objects: np.ndarray  # uint8 [N, Hmax, Wmax, 4], zero padded
    obj_hw: np.ndarray  # int32 [N, 2] = (h, w)
    object_ids: np.ndarray  # int32 [N], -1 for padding slots
    n_valid: int

    def index_of(self, object_id: int) -> int:
        hits = np.nonzero(self.object_ids == object_id)[0]
        if len(hits) == 0:
            raise KeyError(object_id)
        return int(hits[0])


def bundle_arrays_from_numpy(
    objects: np.ndarray, obj_hw: np.ndarray, object_ids: np.ndarray
) -> BundleArrays:
    """BundleArrays from the numpy fields of another package's BundleArrays
    (objects [N, Hmax, Wmax, 4] u8, obj_hw [N, 2], object_ids [N]), so two
    implementations can compose from identical tensors."""
    objects = np.ascontiguousarray(objects, np.uint8)
    object_ids = np.asarray(object_ids, np.int32)
    if objects.ndim != 4 or objects.shape[-1] != 4:
        raise ValueError(f"objects must be [N, H, W, 4], got {objects.shape}")
    return BundleArrays(
        objects=objects,
        obj_hw=np.asarray(obj_hw, np.int32),
        object_ids=object_ids,
        n_valid=int((object_ids >= 0).sum()),
    )


def ensure_bundle(root: os.PathLike) -> Path:
    """Check the bundle directory shape, returning its Path."""
    root = Path(root)
    missing = [
        p for p in ("background.png", "results.json", "objects")
        if not (root / p).exists()
    ]
    if missing:
        raise FileNotFoundError(f"bundle at {root} is missing {missing}")
    return root


def load_bundle(root: os.PathLike) -> Bundle:
    """Load a bundle directory into host memory (PIL + metadata)."""
    root = ensure_bundle(root)
    with open(root / "results.json", "r", encoding="utf-8") as f:
        items = json.load(f)
    objects: Dict[int, Image.Image] = {}
    meta: Dict[int, ObjectMeta] = {}
    for it in items:
        oid = int(it["object_id"])
        img = Image.open(root / it["filename"]).convert("RGBA")
        objects[oid] = img
        bb = it.get("bounding_box", [0.0, 0.0, 0.0, 0.0])
        meta[oid] = ObjectMeta(
            object_id=oid,
            label=str(it.get("label", "")),
            filename=str(it["filename"]),
            width=img.size[0],
            height=img.size[1],
            bounding_box=tuple(float(v) for v in bb),
            per_label_number=int(it.get("per_label_number", 0)),
            confidence_score=float(it.get("confidence_score", 0.0)),
        )
    background = Image.open(root / "background.png").convert("RGBA")
    return Bundle(root=root, objects=objects, meta=meta, background=background, items=items)


def load_bundle_arrays(
    root: os.PathLike,
    n_max: Optional[int] = None,
    pad_hw: Optional[Tuple[int, int]] = None,
) -> Tuple[BundleArrays, List[dict]]:
    """Fast-path ingest: results.json + threaded native PNG decode straight
    into the padded device tensor (no PIL round-trip). Falls back to the
    PIL loader when the native library is unavailable.

    Returns (arrays, items). Object order = ascending object_id (matching
    Bundle.to_arrays()).
    """
    from . import native_io

    root = ensure_bundle(root)
    with open(root / "results.json", "r", encoding="utf-8") as f:
        items = json.load(f)
    # duplicate object_ids keep the LAST occurrence — the dict-keyed PIL
    # loader's semantics — so the native and fallback paths return the
    # same arrays for the same bundle
    items = list({int(it["object_id"]): it for it in items}.values())
    items = sorted(items, key=lambda it: int(it["object_id"]))
    paths = [root / it["filename"] for it in items]
    n = n_max if n_max is not None else len(paths)

    if pad_hw is None:
        dims = [native_io.probe_png(p) for p in paths]
        if any(d is None for d in dims):
            dims = None
        if dims:
            pad_hw = (max(h for _, h in dims), max(w for w, _ in dims))
    result = (
        native_io.batch_decode_into_padded(paths, n, pad_hw)
        if pad_hw is not None
        else None
    )
    if result is None:  # fallback: PIL loader
        bundle = load_bundle(root)
        return bundle.to_arrays(n_max=n_max, pad_hw=pad_hw), items

    tensor, hw = result
    oids = np.full((n,), -1, np.int32)
    for k, it in enumerate(items):
        oids[k] = int(it["object_id"])
    arrays = BundleArrays(
        objects=tensor, obj_hw=hw, object_ids=oids, n_valid=len(items)
    )
    return arrays, items


def load_object_images(results_json_path: os.PathLike) -> Dict[int, Image.Image]:
    """Reference-compatible loader: results.json path -> {id: RGBA image}."""
    results_json_path = Path(results_json_path)
    with open(results_json_path, "r", encoding="utf-8") as f:
        items = json.load(f)
    base = results_json_path.parent
    return {
        int(it["object_id"]): Image.open(base / it["filename"]).convert("RGBA")
        for it in items
    }
