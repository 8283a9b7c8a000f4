"""Driver ``fleet``: the variant fleet, one layout at every ratio in one device pass.

Each pass takes a new Flex layout (drawn from the seed at set-up, never
repeated in a run) through ``layout.solve.FlexProgram.from_dsl`` and
``pipeline.fused.make_fused_render(kernel="pallas")`` (the device solve,
the background plane, K2 and the masked luminance over each variant's true
extent), then reads the boxes and luminances back to the host. The objects
are uploaded once per object order at set-up, as the serving daemon caches
its device inputs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import reference, traffic
from ..harness import CHECKOUT, Check


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.attempted = self.failed = 0

    def setup(self):
        from image_transformation_tpu_torch.core.bundle import load_bundle
        from image_transformation_tpu_torch.layout.canvas import compute_canvas_size
        from image_transformation_tpu_torch.layout.solve import FlexProgram
        from image_transformation_tpu_torch.pipeline import fused

        ctx, p = self.ctx, self.ctx.param
        self.dev = torch.device(ctx.device)
        self.FlexProgram, self.fused = FlexProgram, fused
        bundle = load_bundle(CHECKOUT / ctx.cell.config["bundle"])
        self.bundle, self.arrays = bundle, bundle.to_arrays()
        self.ratios = p("ratios")
        self.budget = tuple(ctx.overrides.get("pixel_budget_wh", ctx.cell.config["pixel_budget_wh"]))
        self.sizes = [compute_canvas_size(self.budget, r, verbose=False) for r in self.ratios]
        self.canvas_max = (max(h for _, h in self.sizes), max(w for w, _ in self.sizes))
        self.obj_pad = tuple(self.arrays.objects.shape[1:3])
        self.canvas_wh = torch.tensor(self.sizes, dtype=torch.int32, device=self.dev)
        bg = torch.from_numpy(np.asarray(bundle.background).copy()).to(self.dev)
        self.bg, self.horizontal = fused.background_spec(bg, p("background"))
        rng = np.random.default_rng(ctx.seed)
        ids = bundle.object_ids()
        self.layouts = traffic.unique_layouts(rng, ids, p("layout_pool"), p("spacing"))
        self.sample_rng = np.random.default_rng([ctx.seed, 1])
        self.inputs = {}
        warm = traffic.unique_layouts(np.random.default_rng([ctx.seed, 2]), ids,
                                      p("warmup_passes"), p("spacing"))
        for doc in warm + self.layouts:  # every object order's device inputs
            self._inputs(FlexProgram.from_dsl(doc["root"]))
        for doc in warm:
            self._pass(doc)

    def _inputs(self, prog):
        key = tuple(int(v) for v in prog.obj_ids)
        if key not in self.inputs:
            objs, wh, known = self.fused.map_bundle_to_program(prog, self.bundle, self.arrays)
            self.inputs[key] = tuple(torch.from_numpy(a).to(self.dev) for a in (objs, wh, known))
        return self.inputs[key]

    def _pass(self, doc):
        spans = self.ctx.spans
        with spans("pass"):
            prog = self.FlexProgram.from_dsl(doc["root"])
            step = self.fused.make_fused_render(
                prog, self.canvas_max, self.obj_pad, kernel="pallas",
                background=self.ctx.param("background"), gradient_horizontal=self.horizontal)
            out, boxes, _scales, luma = step(self.canvas_wh, self.bg, *self._inputs(prog))
        with spans("readback"):
            boxes_h, luma_h = boxes.cpu().numpy(), luma.cpu().numpy()
        return prog, out, boxes_h, luma_h

    def window(self, seconds):
        k = self.ctx.param("samples")
        self.sampled, self.crops = [], [None] * k
        t0 = time.perf_counter()
        t_end = t0 + seconds
        i = 0
        while time.perf_counter() < t_end:
            doc = self.layouts[i % len(self.layouts)]
            prog, out, boxes_h, luma_h = self._pass(doc)
            j = len(self.sampled) if i < k else int(self.sample_rng.integers(0, i + 1))
            if j < k:
                v = int(self.sample_rng.integers(0, len(self.sizes)))
                w, h = self.sizes[v]
                self.crops[j] = out[v, :h, :w].clone()
                entry = (doc, [int(x) for x in prog.obj_ids], boxes_h, luma_h, v)
                if j < len(self.sampled):
                    self.sampled[j] = entry
                else:
                    self.sampled.append(entry)
            i += 1
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        self.attempted = i
        self.ctx.counters["passes"] = i
        return {"canvases_per_s": len(self.sizes) * i / elapsed}

    def memory_peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated()

    def release(self):
        self.crops = [c.cpu() if c is not None else None for c in self.crops]
        self.inputs.clear()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, precision="exact"):
        bg, objects = reference.load_bundle(CHECKOUT / self.ctx.cell.config["bundle"])
        budget = self.budget
        sizes = {oid: (o.shape[1], o.shape[0]) for oid, o in objects.items()}
        mode = self.ctx.param("background")
        boxes_bad, pix, rel = 0, 0, 0.0
        for j, (doc, order, boxes_h, luma_h, v_sampled) in enumerate(self.sampled):
            for v, ratio in enumerate(self.ratios):
                wh = reference.canvas_size(budget, ratio)
                want = reference.solve(doc["root"], wh, sizes)
                got = [(oid, [int(x) for x in boxes_h[v, k]]) for k, oid in enumerate(order)]
                boxes_bad += int(want != got)
                base = reference.background_canvas(bg, wh, mode)
                ref = reference.compose(base, objects, want, self.dev)
                if precision == "exact":
                    img, got_luma = self.crops[j] if v == v_sampled else None, float(luma_h[v])
                else:  # the control: the reference at a lower precision in the program's place
                    img = reference.compose(base, objects, want, self.dev, precision)
                    got_luma = reference.luma(img)
                if v == v_sampled:
                    pix = max(pix, int((img.cpu().to(torch.int16) - ref.cpu().to(torch.int16)).abs().max()))
                r = reference.luma(ref)
                rel = max(rel, abs(got_luma - r) / max(r, 1e-9))
        limits = self.ctx.cell.mix["limits"]
        return [Check("boxes_mismatch", boxes_bad, limits["boxes_mismatch"]),
                Check("pixel_max_err", pix, limits["pixel_max_err"]),
                Check("luma_rel_err", rel, limits["luma_rel_err"])]
