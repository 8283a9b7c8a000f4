"""Driver ``score``: on-device candidate scoring with the batched solid render.

Entry: ``parallel.sweep.make_solid_render_step(reuse=True, stat="luma")``
on the bundle's shared planar objects, its median colour as the solid
background (the program's ``ops.background.masked_median_rgb``). A pool of
box sets drawn from the seed is uploaded at set-up and cycled; each step
renders one set of ``batch`` canvases in place of the previous step's and
returns each canvas's mean luminance, which is copied to the host through
a ring of pinned buffers. A reservoir drawn from the seed keeps device
copies of a few canvases of the window for the check.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import reference, traffic
from ..harness import CHECKOUT, Check, median


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.attempted = self.failed = 0

    # ------------------------------------------------------------------ set-up
    def setup(self):
        from image_transformation_tpu_torch.core.bundle import load_bundle
        from image_transformation_tpu_torch.ops.background import masked_median_rgb
        from image_transformation_tpu_torch.ops.compose_kernels import planarize_objects
        from image_transformation_tpu_torch.parallel import sweep

        ctx, p = self.ctx, self.ctx.param
        self.dev = torch.device(ctx.device)
        self.bundle = load_bundle(CHECKOUT / ctx.cell.config["bundle"])
        arrays = self.bundle.to_arrays()
        self.objects, self.obj_hw = arrays.objects, arrays.obj_hw
        self.H, self.W = p("canvas_hw")
        self.B, S = p("batch"), p("box_sets")
        rng = np.random.default_rng(ctx.seed)
        self.pool = traffic.box_pool(rng, self.obj_hw, (self.H, self.W), S, self.B)
        self.pool_dev = torch.from_numpy(self.pool).to(self.dev)
        self.objs_p = planarize_objects(torch.from_numpy(self.objects[None]).to(self.dev))
        n = self.obj_hw.shape[0]
        self.hw_dev = torch.from_numpy(np.broadcast_to(self.obj_hw, (self.B, n, 2)).copy()).to(self.dev)
        bg_np = np.asarray(self.bundle.background, np.uint8)
        median_rgb = masked_median_rgb(torch.from_numpy(bg_np.copy()).to(self.dev)).tolist()
        self.bg_rgba = (*(int(v) for v in median_rgb), 255)
        static_hw = tuple(tuple(int(v) for v in row) for row in self.obj_hw)
        if ctx.trace:
            # a span around the program's call into its statistic
            inner = sweep.packed_luma

            def spanned(crop):
                with ctx.spans("stat"):
                    return inner(crop)

            sweep.packed_luma = spanned
            self._restore = lambda: setattr(sweep, "packed_luma", inner)
        self.step = sweep.make_solid_render_step(
            (self.H, self.W), (arrays.objects.shape[1], arrays.objects.shape[2]),
            bg_rgba=self.bg_rgba, static_obj_hw=static_hw, reuse=True, stat="luma",
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
    def _drain(self, slot, lumas):
        if self.events[slot] is not None:
            if self.events[slot] is not True:
                self.events[slot].synchronize()
            lumas.append(self.ring[slot].numpy().copy())
            self.events[slot] = None

    def window(self, seconds):
        spans, S, R = self.ctx.spans, self.pool.shape[0], len(self.ring)
        self.lumas, self.sampled, self.sets = [], [], []
        t0 = time.perf_counter()
        t_end = t0 + seconds
        i = 0
        while time.perf_counter() < t_end:
            s = (self.first + i) % S
            slot = i % R
            with spans("readback"):
                self._drain(slot, self.lumas)
            with spans("step"):
                plane, luma = self.step(None, self.objs_p, self.hw_dev, self.pool_dev[s])
            # reservoir sample of (step, canvas), decided on the host from the seed
            j = len(self.sampled) if i < self.k else int(self.sample_rng.integers(0, i + 1))
            if j < self.k:
                b = int(self.sample_rng.integers(0, self.B))
                self.snaps[j].copy_(plane[b, :self.H, :self.W])
                entry = (i, s, b)
                if j < len(self.sampled):
                    self.sampled[j] = entry
                else:
                    self.sampled.append(entry)
            with spans("readback"):
                self.ring[slot].copy_(luma, non_blocking=True)
                if self.dev.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record()
                    self.events[slot] = ev
                else:
                    self.events[slot] = True
            self.sets.append(s)
            i += 1
        for k in range(i, i + R):  # every step's luminances reach the host
            self._drain(k % R, self.lumas)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        self.attempted = i
        # the ring drains in step order: lumas[k] is step k's
        self.ctx.counters["step_host_ms"] = median(self.ctx.spans.durations_ms("step"))
        self.ctx.counters["work"] = self.work
        return {"canvases_per_s": self.B * i / elapsed}

    def memory_peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated()

    def work(self):
        """(render bytes, multiply-adds, statistic bytes) of the window's steps."""
        from ..roofline import RenderWork, stat_bytes

        rw = RenderWork(self.objects, self.obj_hw, self.pool, (self.H, self.W), self.dev)
        nbytes, macs, prev = 0, 0, self.prev_set
        for s in self.sets:
            nbytes += rw.render_bytes(prev, s)
            macs += rw.macs(s)
            prev = s
        return nbytes, macs, stat_bytes(self.B, (self.H, self.W)) * len(self.sets)

    def release(self):
        if hasattr(self, "_restore"):
            self._restore()
        self._drop_plane()
        self.snap_host = self.snaps.cpu().numpy()
        del self.step, self.snaps, self.pool_dev, self.objs_p, self.hw_dev
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------ check
    def check(self, precision="exact"):
        bg, objects = reference.load_bundle(CHECKOUT / self.ctx.cell.config["bundle"])
        base = reference.background_canvas(bg, (self.W, self.H), "solid")
        ids = sorted(objects)  # the pool's object axis is in id order
        pix, rel = 0, 0.0
        for j, (i, s, b) in enumerate(self.sampled):
            placements = [(oid, self.pool[s, b, k].tolist()) for k, oid in enumerate(ids)]
            ref = reference.compose(base, objects, placements, self.dev)
            if precision == "exact":
                got = torch.from_numpy(self.snap_host[j].view(np.uint8).reshape(self.H, self.W, 4))
                got_luma = float(self.lumas[i][b])
            else:  # the control: the reference at a lower precision in the program's place
                got = reference.compose(base, objects, placements, self.dev, precision).cpu()
                got_luma = reference.luma(got)
            pix = max(pix, int((got.to(torch.int16) - ref.cpu().to(torch.int16)).abs().max()))
            r = reference.luma(ref)
            rel = max(rel, abs(got_luma - r) / max(r, 1e-9))
        limits = self.ctx.cell.mix["limits"]
        return [Check("pixel_max_err", pix, limits["pixel_max_err"]),
                Check("luma_rel_err", rel, limits["luma_rel_err"])]
