"""Driver ``draft``: the interactive loop's compose step, one user, closed loop.

Each draft is the body of ``pipeline/run.py``'s ``compose_iter_*`` step
without its file writes: ``layout.flex.solve_flex`` on a new Flex layout
(drawn from the seed, never repeated in a run), ``ComposeEngine.compose``
(K1 on the card) ending in a synchronise, the host copy, and
``core.native_io.png_bytes``. The engine holds the bundle's objects and
the synthesized background canvas of the cell, built once at set-up.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import reference, traffic
from ..harness import CHECKOUT, Check, percentile


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.attempted = self.failed = 0

    def setup(self):
        from image_transformation_tpu_torch.core.bundle import load_bundle
        from image_transformation_tpu_torch.core.native_io import png_bytes
        from image_transformation_tpu_torch.layout.canvas import compute_canvas_size
        from image_transformation_tpu_torch.layout.flex import solve_flex
        from image_transformation_tpu_torch.ops.background import synthesize_canvas
        from image_transformation_tpu_torch.pipeline.engine import ComposeEngine

        ctx, p = self.ctx, self.ctx.param
        self.dev = torch.device(ctx.device)
        self.solve_flex, self.png_bytes = solve_flex, png_bytes
        bundle = load_bundle(CHECKOUT / ctx.cell.config["bundle"])
        self.canvas_size = compute_canvas_size(bundle.background.size, p("ratio"), verbose=False)
        W, H = self.canvas_size
        canvas = synthesize_canvas(
            torch.from_numpy(np.asarray(bundle.background).copy()).to(self.dev), W, H,
            p("background"))
        self.engine = ComposeEngine(bundle.to_arrays(), canvas, self.dev)
        self.sizes, self.labels = bundle.sizes(), bundle.id_to_label()
        rng = np.random.default_rng(ctx.seed)
        self.layouts = traffic.unique_layouts(rng, bundle.object_ids(), p("layout_pool"),
                                              p("spacing"))
        self.sample_rng = np.random.default_rng([ctx.seed, 1])
        warm = traffic.unique_layouts(np.random.default_rng([ctx.seed, 2]), bundle.object_ids(),
                                      p("warmup_drafts"), p("spacing"))
        for doc in warm:
            self._draft(doc)

    def _draft(self, doc):
        spans = self.ctx.spans
        with spans("draft"):
            with spans("solve"):
                placements = [dict(pl, name=self.labels.get(int(pl["object_id"]), ""))
                              for pl in self.solve_flex(doc["root"], self.canvas_size, self.sizes)]
            with spans("compose"):
                out = self.engine.compose(placements)
                if self.dev.type == "cuda":
                    torch.cuda.synchronize()
            with spans("readback"):
                img = out.cpu().numpy()
            with spans("encode"):
                png = self.png_bytes(img)
        return placements, png

    def window(self, seconds):
        k = self.ctx.param("samples")
        self.sampled = []
        spans = self.ctx.spans
        first = len(spans.records)
        t_end = time.perf_counter() + seconds
        i = 0
        while time.perf_counter() < t_end:
            doc = self.layouts[i % len(self.layouts)]
            try:
                placements, png = self._draft(doc)
            except Exception:  # noqa: BLE001 - a failed draft is counted, the loop goes on
                self.failed += 1
                i += 1
                continue
            j = len(self.sampled) if i < k else int(self.sample_rng.integers(0, i + 1))
            if j < k:
                entry = (doc, [(int(pl["object_id"]), list(pl["box"])) for pl in placements], png)
                if j < len(self.sampled):
                    self.sampled[j] = entry
                else:
                    self.sampled.append(entry)
            i += 1
        self.attempted = i
        window = type(spans)(False)
        window.records = spans.records[first:]
        self.ctx.counters["spans"] = window
        drafts = window.durations_ms("draft") + [float("inf")] * self.failed
        return {"draft_p50_ms": percentile(drafts, 50), "draft_p95_ms": percentile(drafts, 95)}

    def memory_peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated()

    def release(self):
        del self.engine
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, precision="exact"):
        bg, objects = reference.load_bundle(CHECKOUT / self.ctx.cell.config["bundle"])
        p = self.ctx.param
        wh = reference.canvas_size((bg.shape[1], bg.shape[0]), p("ratio"))
        base = reference.background_canvas(bg, wh, p("background"))
        sizes = {oid: (o.shape[1], o.shape[0]) for oid, o in objects.items()}
        boxes_bad, pix = 0, 0
        for doc, placed, png in self.sampled:
            want = reference.solve(doc["root"], wh, sizes)
            boxes_bad += int(want != placed)
            ref = reference.compose(base, objects, want, "cpu").numpy()
            if precision == "exact":
                got = reference.decode_png(png)
            else:
                got = reference.compose(base, objects, want, "cpu", precision).numpy()
            pix = max(pix, int(np.abs(got.astype(np.int16) - ref).max()) if got.shape == ref.shape
                      else 255)
        limits = self.ctx.cell.mix["limits"]
        return [Check("boxes_mismatch", boxes_bad, limits["boxes_mismatch"]),
                Check("png_max_err", pix, limits["png_max_err"])]
