"""Driver ``score_up``: on-device candidate scoring with the batched gradient
render, every cutout scaled up to screen size.

Entry: ``parallel.sweep.make_gradient_render_step(reuse=True, stat="luma")``
on the bundle's shared planar objects, the bundle's own gradient as the
background (the program's ``ops.background.gradient_spec``, the upstream
fill_gradient) and per-object output bounds at the largest scale. The
window, the ring of pinned buffers and the reservoir of checked canvases
are the ``score`` driver's; this driver brings its own boxes, work model
and check.

Boxes: s0 = sqrt(canvas px / original px) keeps each cutout's share of the
canvas (the upstream canvas keeps the original's pixel count); each object
of each canvas independently takes one of ``scale_levels`` scales evenly
spaced over ``scale_range`` times s0, its size rounded, at a uniform origin
with the whole box inside the canvas, all drawn from the seed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import reference
from ..harness import CHECKOUT, Check
from . import score


def scale_levels(canvas_hw: Tuple[int, int], original_wh: Tuple[int, int], levels: int,
                 scale_range: Tuple[float, float]) -> np.ndarray:
    """The ``levels`` scales evenly spaced over ``scale_range`` times s0."""
    s0 = math.sqrt(canvas_hw[0] * canvas_hw[1] / (original_wh[0] * original_wh[1]))
    return s0 * np.linspace(scale_range[0], scale_range[1], levels)


def level_sizes(obj_hw: np.ndarray, levels: np.ndarray) -> np.ndarray:
    """int [N, L, 2] (h, w): each object's box size at each level, rounded, at least 1."""
    hw = np.asarray(obj_hw, np.float64)[:, None, :] * levels[None, :, None]
    return np.maximum(1, np.rint(hw)).astype(np.int64)


def up_boxes(rng: np.random.Generator, sizes: np.ndarray, canvas_hw: Tuple[int, int]) -> np.ndarray:
    """One canvas's placements, int32 [N, 4]: each object at a level drawn
    uniformly, at a uniform origin with the whole box inside the canvas."""
    H, W = canvas_hw
    N, L, _ = sizes.shape
    boxes = np.zeros((N, 4), np.int32)
    for k in range(N):
        h, w = (int(v) for v in sizes[k, int(rng.integers(0, L))])
        if h > H or w > W:
            raise ValueError(f"object {k} at {w}x{h} does not fit the {W}x{H} canvas")
        x1 = int(rng.integers(0, W - w + 1))
        y1 = int(rng.integers(0, H - h + 1))
        boxes[k] = (x1, y1, x1 + w, y1 + h)
    return boxes


def up_pool(rng: np.random.Generator, sizes: np.ndarray, canvas_hw: Tuple[int, int], sets: int,
            batch: int) -> np.ndarray:
    """int32 [sets, batch, N, 4] placements."""
    return np.stack([np.stack([up_boxes(rng, sizes, canvas_hw) for _ in range(batch)])
                     for _ in range(sets)])


class Driver(score.Driver):
    # ------------------------------------------------------------------ set-up
    def setup(self):
        # first, so that a program without the gradient step fails at once
        from image_transformation_tpu_torch.parallel.sweep import make_gradient_render_step
        from image_transformation_tpu_torch.core.bundle import load_bundle
        from image_transformation_tpu_torch.ops.background import gradient_spec
        from image_transformation_tpu_torch.ops.compose_kernels import planarize_objects
        from image_transformation_tpu_torch.parallel import sweep

        ctx, p = self.ctx, self.ctx.param
        if p("background") != "gradient":
            raise ValueError(f"score_up renders on the gradient, not {p('background')!r}")
        self.dev = torch.device(ctx.device)
        self.bundle = load_bundle(CHECKOUT / ctx.cell.config["bundle"])
        arrays = self.bundle.to_arrays()
        self.objects, self.obj_hw = arrays.objects, arrays.obj_hw
        self.H, self.W = p("canvas_hw")
        self.B, S = p("batch"), p("box_sets")
        levels = scale_levels((self.H, self.W), ctx.cell.config["original_wh"],
                              p("scale_levels"), p("scale_range"))
        self.sizes = level_sizes(self.obj_hw, levels)
        self.bounds = tuple(tuple(int(v) for v in row) for row in self.sizes.max(axis=1))
        rng = np.random.default_rng(ctx.seed)
        self.pool = up_pool(rng, self.sizes, (self.H, self.W), S, self.B)
        self.pool_dev = torch.from_numpy(self.pool).to(self.dev)
        self.objs_p = planarize_objects(torch.from_numpy(self.objects[None]).to(self.dev))
        n = self.obj_hw.shape[0]
        self.hw_dev = torch.from_numpy(np.broadcast_to(self.obj_hw, (self.B, n, 2)).copy()).to(self.dev)
        bg_np = np.asarray(self.bundle.background, np.uint8)
        self.gradient = gradient_spec(torch.from_numpy(bg_np.copy()).to(self.dev))
        if ctx.trace:
            # a span around the program's call into its statistic, as the score driver's
            inner = sweep.packed_luma

            def spanned(crop):
                with ctx.spans("stat"):
                    return inner(crop)

            sweep.packed_luma = spanned
            self._restore = lambda: setattr(sweep, "packed_luma", inner)
        self.step = make_gradient_render_step(
            (self.H, self.W), self.bounds, self.gradient, reuse=True, stat="luma",
            device=str(self.dev))
        self._drop_plane = self.step.release
        pin = self.dev.type == "cuda"
        self.ring = [torch.empty((self.B,), dtype=torch.float32, pin_memory=pin)
                     for _ in range(p("ring"))]
        self.events = [None] * len(self.ring)
        self.k = p("samples")
        self.snaps = torch.empty((self.k, self.H, self.W), dtype=torch.int32, device=self.dev)
        self.sample_rng = np.random.default_rng([ctx.seed, 1])
        warm = p("warmup_steps")
        for i in range(warm):  # the fresh render, then reuse renders
            _, luma = self.step(None, self.objs_p, self.hw_dev, self.pool_dev[i % S])
            luma.cpu()
        self.first = warm % S
        self.prev_set = (warm - 1) % S

    # ------------------------------------------------------------------ window
    def window(self, seconds):
        from image_transformation_tpu_torch.ops import compose_kernels

        launches = compose_kernels.LAUNCHES
        chunks0 = launches.get("fused_v3_chunks")
        out = super().window(seconds)
        if chunks0 is not None and self.dev.type == "cuda":
            self.ctx.counters["k2_chunks"] = launches["fused_v3_chunks"] - chunks0
        self.ctx.counters["steps"] = self.attempted
        self.ctx.counters["work_split"] = self.work_split
        return out

    def work_split(self) -> Dict[str, List[int]]:
        """Per step of the window: the restore's bytes (the previous set's
        changed pixels written back, 4 B), the compose's bytes (this set's
        changed pixels read and written, 8 B, and the placed objects read)
        and multiply-adds, and the statistic's bytes."""
        from ..roofline import RenderWork, stat_bytes

        rw = RenderWork(self.objects, self.obj_hw, self.pool, (self.H, self.W), self.dev)
        out = {"restore_bytes": [], "compose_bytes": [], "macs": [], "stat_bytes": []}
        prev = self.prev_set
        for s in self.sets:
            out["restore_bytes"].append(4 * rw.changed_pixels(prev))
            out["compose_bytes"].append(8 * rw.changed_pixels(s) + rw.object_bytes(s))
            out["macs"].append(rw.macs(s))
            out["stat_bytes"].append(stat_bytes(self.B, (self.H, self.W)))
            prev = s
        return out

    # ------------------------------------------------------------------ check
    def check(self, precision="exact"):
        bg, objects = reference.load_bundle(CHECKOUT / self.ctx.cell.config["bundle"])
        base = reference.background_canvas(bg, (self.W, self.H), "gradient")
        base_t = torch.from_numpy(base).to(self.dev).to(torch.int16)
        ids = sorted(objects)  # the pool's object axis is in id order
        pix, rel, off_err = 0, 0.0, 0
        for j, (i, s, b) in enumerate(self.sampled):
            placements = [(oid, self.pool[s, b, k].tolist()) for k, oid in enumerate(ids)]
            ref = reference.compose(base, objects, placements, self.dev)
            if precision == "exact":
                got = torch.from_numpy(self.snap_host[j].view(np.uint8).reshape(self.H, self.W, 4))
                got_luma = float(self.lumas[i][b])
            else:  # the control: the reference at a lower precision in the program's place
                got = reference.compose(base, objects, placements, self.dev, precision).cpu()
                got_luma = reference.luma(got)
            got = got.to(self.dev).to(torch.int16)
            pix = max(pix, int((got - ref.to(torch.int16)).abs().max()))
            off = torch.ones((self.H, self.W), dtype=torch.bool, device=self.dev)
            for _, (x1, y1, x2, y2) in placements:
                off[y1:y2, x1:x2] = False
            if bool(off.any()):
                off_err = max(off_err, int((got - base_t).abs().amax(dim=-1)[off].max()))
            r = reference.luma(ref)
            rel = max(rel, abs(got_luma - r) / max(r, 1e-9))
        limits = self.ctx.cell.mix["limits"]
        return [Check("pixel_max_err", pix, limits["pixel_max_err"]),
                Check("luma_rel_err", rel, limits["luma_rel_err"]),
                Check("background_max_err", off_err, limits["background_max_err"])]
