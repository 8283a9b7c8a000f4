"""Driver ``campaign``: a campaign of creatives re-laid into every placement
format of a 4K screen network, one batched gradient step per ratio.

Entry: ``parallel.sweep.make_gradient_render_step(reuse=True, stat="luma")``,
one step per ratio of the mix, their calls taking turns step by step. Each
step renders ``batch`` canvases; canvas b carries bundle b % len(bundles)'s
own planar cutouts (objects [B, N, ...], one creative per canvas, padded to
the bundles' most objects with empty slots of size (0, 0)) on that bundle's
own gradient (a line per canvas). Each ratio has its own per-object output
bounds, the largest boxes its levels give. The window and the ring of
pinned buffers follow the ``score`` driver's. The checked canvases are
sampled by stratum: a reservoir for each (ratio, bundle), so that every
geometry and every creative is checked in every run; the check composes
each sampled canvas with the plain reference from its own bundle and
gradient.

Boxes: s0 = sqrt(canvas px / original px) keeps each cutout's share of the
canvas (every ratio of one budget has the same s0); each object of each
canvas takes one of the ``scale_levels`` scales over ``scale_range`` times
s0, drawn uniformly from those at which its box fits the canvas, at a
uniform origin with the whole box inside the canvas, all from the seed.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import reference
from ..harness import CHECKOUT, Check, median
from . import score_up


def fitting_levels(sizes: np.ndarray, canvas_hw: Tuple[int, int]) -> np.ndarray:
    """bool [N, L]: the levels at which each object's box fits the canvas."""
    H, W = canvas_hw
    return (sizes[..., 0] <= H) & (sizes[..., 1] <= W)


def campaign_boxes(rng: np.random.Generator, sizes: Sequence[np.ndarray], n_slots: int,
                   canvas_hw: Tuple[int, int], batch: int) -> np.ndarray:
    """One step's placements, int32 [batch, n_slots, 4]: canvas b takes
    bundle b % len(sizes), whose objects (``sizes[i]`` int [n_i, L, 2]) each
    take a fitting level drawn uniformly and a uniform origin with the whole
    box inside the canvas; slots past a bundle's objects stay (0, 0, 0, 0)."""
    H, W = canvas_hw
    out = np.zeros((batch, n_slots, 4), np.int32)
    for b in range(batch):
        lv = sizes[b % len(sizes)]
        fits = fitting_levels(lv, canvas_hw)
        for k in range(lv.shape[0]):
            choices = np.flatnonzero(fits[k])
            if not len(choices):
                raise ValueError(f"object {k} fits the {W}x{H} canvas at no level")
            h, w = (int(v) for v in lv[k, int(choices[int(rng.integers(0, len(choices)))])])
            x1 = int(rng.integers(0, W - w + 1))
            y1 = int(rng.integers(0, H - h + 1))
            out[b, k] = (x1, y1, x1 + w, y1 + h)
    return out


def ratio_bounds(sizes: Sequence[np.ndarray], n_slots: int,
                 canvas_hw: Tuple[int, int]) -> Tuple[Tuple[int, int], ...]:
    """Per slot, the (h, w) bound of a ratio: the largest box of any bundle's
    object in that slot over the levels at which it fits the canvas."""
    bounds = np.ones((n_slots, 2), np.int64)
    for lv in sizes:
        fits = fitting_levels(lv, canvas_hw)
        for k in range(lv.shape[0]):
            bounds[k] = np.maximum(bounds[k], lv[k][fits[k]].max(axis=0))
    return tuple((int(h), int(w)) for h, w in bounds)


class Driver(score_up.Driver):
    # ------------------------------------------------------------------ set-up
    def setup(self):
        # first, so that a program without the gradient step fails at once
        from image_transformation_tpu_torch.parallel.sweep import make_gradient_render_step
        from image_transformation_tpu_torch.core.bundle import load_bundle
        from image_transformation_tpu_torch.ops.background import gradient_spec
        from image_transformation_tpu_torch.ops.compose_kernels import planarize_objects
        from image_transformation_tpu_torch.parallel import sweep

        ctx, p, cfg = self.ctx, self.ctx.param, self.ctx.cell.config
        if p("background") != "gradient":
            raise ValueError(f"campaign renders on the gradient, not {p('background')!r}")
        self.dev = torch.device(ctx.device)
        budget = ctx.overrides.get("pixel_budget_wh", cfg["pixel_budget_wh"])
        self.ratios = list(p("ratios"))
        self.canvases = [reference.canvas_size(tuple(budget), r)[::-1] for r in self.ratios]
        self.B, S, R = p("batch"), p("box_sets"), len(self.ratios)
        bundles = [load_bundle(CHECKOUT / path) for path in cfg["bundles"]]
        self.n_slots = max(len(b.meta) for b in bundles)
        pad_hw = (max(m.height for b in bundles for m in b.meta.values()),
                  max(m.width for b in bundles for m in b.meta.values()))
        arrays = [b.to_arrays(n_max=self.n_slots, pad_hw=pad_hw) for b in bundles]
        self.n_objects = [len(b.meta) for b in bundles]
        self.objects = [a.objects[:n] for a, n in zip(arrays, self.n_objects)]
        self.obj_hw = [a.obj_hw[:n] for a, n in zip(arrays, self.n_objects)]
        levels = score_up.scale_levels(tuple(budget[::-1]), cfg["original_wh"], p("scale_levels"),
                                       p("scale_range"))
        self.sizes = [score_up.level_sizes(hw, levels) for hw in self.obj_hw]
        rng = np.random.default_rng(ctx.seed)
        self.pool = np.stack([  # int32 [R, S, B, N, 4]
            np.stack([campaign_boxes(rng, self.sizes, self.n_slots, hw, self.B) for _ in range(S)])
            for hw in self.canvases])
        self.pool_dev = torch.from_numpy(self.pool).to(self.dev)
        which = [b % len(bundles) for b in range(self.B)]
        self.objs_p = planarize_objects(
            torch.from_numpy(np.stack([arrays[i].objects for i in which])).to(self.dev))
        self.hw_dev = torch.from_numpy(np.stack([arrays[i].obj_hw for i in which])).to(self.dev)
        specs = [gradient_spec(torch.from_numpy(np.asarray(b.background, np.uint8).copy())
                               .to(self.dev)) for b in bundles]
        gradient = tuple(np.array([specs[i][j] for i in which], np.uint8) for j in (0, 1))
        self.gradient = (*gradient, [bool(specs[i][2]) for i in which])
        if ctx.trace:
            # a span around the program's call into its statistic, as the score driver's
            inner = sweep.packed_luma

            def spanned(crop):
                with ctx.spans("stat"):
                    return inner(crop)

            sweep.packed_luma = spanned
            self._restore = lambda: setattr(sweep, "packed_luma", inner)
        self.steps = [make_gradient_render_step(hw, ratio_bounds(self.sizes, self.n_slots, hw),
                                                self.gradient, reuse=True, stat="luma",
                                                device=str(self.dev))
                      for hw in self.canvases]
        pin = self.dev.type == "cuda"
        self.ring = [torch.empty((self.B,), dtype=torch.float32, pin_memory=pin)
                     for _ in range(p("ring"))]
        self.events = [None] * len(self.ring)
        # a reservoir of k canvases for each (ratio, bundle), k from the mix's samples
        self.k = max(1, p("samples") // (R * len(bundles)))
        self.snaps = torch.empty((R * len(bundles) * self.k, max(h * w for h, w in self.canvases)),
                                 dtype=torch.int32, device=self.dev)
        self.sample_rng = np.random.default_rng([ctx.seed, 1])
        warm = p("warmup_steps")
        if warm < 2 * R:
            raise ValueError(f"warmup_steps {warm} must take each of the {R} ratios fresh and reused")
        for g in range(warm):  # each ratio's fresh render, then reuse renders
            r, s = g % R, (g // R) % S
            _, luma = self.steps[r](None, self.objs_p, self.hw_dev, self.pool_dev[r, s])
            luma.cpu()
        self.first = warm

    # ------------------------------------------------------------------ window
    def window(self, seconds):
        from image_transformation_tpu_torch.ops import compose_kernels

        launches = compose_kernels.LAUNCHES
        lines0, chunks0 = launches.get("restore_windows_lines"), launches.get("fused_v3_chunks")
        spans, S, R, ring = self.ctx.spans, self.pool.shape[1], len(self.steps), len(self.ring)
        nb = len(self.objects)
        self.lumas, self.sets, self._split = [], [], None
        self.sampled = [None] * self.snaps.shape[0]
        seen = [0] * R  # steps of each ratio so far
        t0 = time.perf_counter()
        t_end = t0 + seconds
        i = 0
        while time.perf_counter() < t_end:
            g = self.first + i
            r, s = g % R, (g // R) % S
            H, W = self.canvases[r]
            slot = i % ring
            with spans("readback"):
                self._drain(slot, self.lumas)
            with spans("step"):
                plane, luma = self.steps[r](None, self.objs_p, self.hw_dev, self.pool_dev[r, s])
            # a reservoir of (step, canvas) for each (ratio, bundle), decided on the host
            # from the seed
            seen[r] += 1
            for q in range(nb):
                n = seen[r]
                j = n - 1 if n <= self.k else int(self.sample_rng.integers(0, n))
                if j < self.k:
                    b = q + nb * int(self.sample_rng.integers(0, len(range(q, self.B, nb))))
                    at = (r * nb + q) * self.k + j
                    self.snaps[at, :H * W].view(H, W).copy_(plane[b, :H, :W])
                    self.sampled[at] = (i, r, s, b)
            with spans("readback"):
                self.ring[slot].copy_(luma, non_blocking=True)
                if self.dev.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record()
                    self.events[slot] = ev
                else:
                    self.events[slot] = True
            self.sets.append((r, s))
            i += 1
        for k in range(i, i + ring):  # every step's luminances reach the host
            self._drain(k % ring, self.lumas)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        self.attempted = i
        counters = self.ctx.counters
        if self.dev.type == "cuda":  # counters a program without them leaves out
            if lines0 is not None:
                counters["k3_line_restores"] = launches["restore_windows_lines"] - lines0
            if chunks0 is not None:
                counters["k2_chunks"] = launches["fused_v3_chunks"] - chunks0
        counters["steps"] = i
        counters["step_host_ms"] = median(spans.durations_ms("step"))
        counters["work"] = self.work
        counters["work_split"] = self.work_split
        return {"canvases_per_s": self.B * i / elapsed}

    def work(self) -> Tuple[int, int, int]:
        """(render bytes, multiply-adds, statistic bytes) of the window's
        steps: :meth:`work_split` summed."""
        w = self.work_split()
        return (sum(w["restore_bytes"]) + sum(w["compose_bytes"]), sum(w["macs"]),
                sum(w["stat_bytes"]))

    def work_split(self) -> Dict[str, List[int]]:
        """Per step of the window: the restore's bytes (4 B a pixel the
        previous step of the same ratio changed), the compose's bytes (8 B a
        pixel this step changes, and each canvas's own placed cutouts' live
        pixels read, 4 B), the resample's multiply-adds and the statistic's
        bytes. The work model of ``bench_torch/roofline``, per bundle over
        its canvases; computed once."""
        if self._split is not None:
            return self._split
        from ..roofline import RenderWork, stat_bytes

        nb = len(self.objects)
        work = [[RenderWork(self.objects[i], self.obj_hw[i],
                            self.pool[r][:, i::nb, :self.n_objects[i]], hw, self.dev)
                 for i in range(nb)] for r, hw in enumerate(self.canvases)]
        live = [[4 * int(np.count_nonzero(self.objects[i][k, :h, :w, 3]))
                 for k, (h, w) in enumerate(self.obj_hw[i].tolist())] for i in range(nb)]
        src_bytes: Dict[tuple, int] = {}

        def changed(r, s):
            return sum(w.changed_pixels(s) for w in work[r])

        def own_objects(r, s):  # every canvas reads its own copy of the cutouts it places
            if (r, s) not in src_bytes:
                H, W = self.canvases[r]
                total = 0
                for b in range(self.B):
                    i = b % nb
                    for k in range(self.n_objects[i]):
                        x1, y1 = (int(v) for v in self.pool[r, s, b, k, :2])
                        if 0 <= x1 < W and 0 <= y1 < H:
                            total += live[i][k]
                src_bytes[(r, s)] = total
            return src_bytes[(r, s)]

        out = {"restore_bytes": [], "compose_bytes": [], "macs": [], "stat_bytes": []}
        S, R = self.pool.shape[1], len(self.canvases)
        for idx, (r, s) in enumerate(self.sets):
            prev = (self.first + idx - R) // R % S
            out["restore_bytes"].append(4 * changed(r, prev))
            out["compose_bytes"].append(8 * changed(r, s) + own_objects(r, s))
            out["macs"].append(sum(w.macs(s) for w in work[r]))
            out["stat_bytes"].append(stat_bytes(self.B, self.canvases[r]))
        self._split = out
        return out

    def release(self):
        if hasattr(self, "_restore"):
            self._restore()
        for step in self.steps:
            step.release()
        self.snap_host = self.snaps.cpu().numpy()
        del self.steps, self.snaps, self.pool_dev, self.objs_p, self.hw_dev
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------ check
    def check(self, precision="exact"):
        # the reference's float products stay in their own precision, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = self.ctx.cell.config
        loaded = [reference.load_bundle(CHECKOUT / path) for path in cfg["bundles"]]
        bases: Dict[tuple, np.ndarray] = {}
        pix, rel, off_err = 0, 0.0, 0
        for j, entry in enumerate(self.sampled):
            if entry is None:  # a ratio the window never reached
                continue
            i, r, s, b = entry
            H, W = self.canvases[r]
            which = b % len(loaded)
            bg, objects = loaded[which]
            if (r, which) not in bases:  # the canvas's own bundle's gradient
                bases[(r, which)] = reference.background_canvas(bg, (W, H), "gradient")
            base = bases[(r, which)]
            ids = sorted(objects)  # the pool's slots are the bundle's objects in id order
            placements = [(oid, self.pool[r, s, b, k].tolist()) for k, oid in enumerate(ids)]
            ref = reference.compose(base, objects, placements, self.dev)
            if precision == "exact":
                got = torch.from_numpy(
                    self.snap_host[j, :H * W].view(np.uint8).reshape(H, W, 4).copy())
                got_luma = float(self.lumas[i][b])
            else:  # the control: the reference at a lower precision in the program's place
                got = reference.compose(base, objects, placements, self.dev, precision).cpu()
                got_luma = reference.luma(got)
            got = got.to(self.dev).to(torch.int16)
            pix = max(pix, int((got - ref.to(torch.int16)).abs().max()))
            off = torch.ones((H, W), dtype=torch.bool, device=self.dev)
            for _, (x1, y1, x2, y2) in placements:
                off[y1:y2, x1:x2] = False
            if bool(off.any()):
                base_t = torch.from_numpy(base).to(self.dev).to(torch.int16)
                off_err = max(off_err, int((got - base_t).abs().amax(dim=-1)[off].max()))
            rl = reference.luma(ref)
            rel = max(rel, abs(got_luma - rl) / max(rl, 1e-9))
        limits = self.ctx.cell.mix["limits"]
        return [Check("pixel_max_err", pix, limits["pixel_max_err"]),
                Check("luma_rel_err", rel, limits["luma_rel_err"]),
                Check("background_max_err", off_err, limits["background_max_err"])]
