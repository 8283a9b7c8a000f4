"""Library API end-to-end on the GPU: bundle -> layout -> K1 compose -> PNG.

The port of examples/01_compose.py. Loads a segmented ad bundle, computes
the pixel-budget canvas for a new aspect ratio, makes the solid
median-colour background on the device, solves a small Flex-DSL layout
into pixel boxes, and composites the cutouts with ComposeEngine (K1 on a
CUDA card, its plain version with ``--device cpu``), bit-exact vs PIL's
LANCZOS resize + alpha_composite.

    python image_transformation_tpu_torch/examples/01_compose.py [--device cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from image_transformation_tpu_torch.core.bundle import load_bundle  # noqa: E402
from image_transformation_tpu_torch.core.device import resolve_device  # noqa: E402
from image_transformation_tpu_torch.layout.canvas import compute_canvas_size  # noqa: E402
from image_transformation_tpu_torch.layout.flex import solve_flex  # noqa: E402
from image_transformation_tpu_torch.ops.background import (  # noqa: E402
    masked_median_rgb,
    solid_canvas,
)
from image_transformation_tpu_torch.pipeline.engine import ComposeEngine  # noqa: E402


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = resolve_device(parser.parse_args(argv).device)
    bundle = load_bundle(REPO / "data" / "squarespace")

    # 9:16 canvas preserving the original's pixel budget
    width, height = compute_canvas_size(bundle.background.size, "9:16")

    # solid background from the median colour of the original's opaque pixels
    background = np.asarray(bundle.background.convert("RGBA")).copy()
    color = masked_median_rgb(torch.from_numpy(background).to(device))
    canvas = solid_canvas(color, height, width)

    # a single-column layout over every object, centred
    layout = {
        "type": "flex",
        "direction": "column",
        "justify": "space_around",
        "align": "center",
        "children": [
            {"object_id": int(oid), "name": meta.label}
            for oid, meta in sorted(bundle.meta.items())
        ],
    }
    placements = solve_flex(layout, (width, height), bundle.sizes())

    engine = ComposeEngine(bundle.to_arrays(), canvas, device)
    composed = engine.compose(placements).cpu().numpy()
    out_path = Path(tempfile.gettempdir()) / "itpu_torch_example_compose.png"
    Image.fromarray(composed, "RGBA").save(out_path)
    print(f"composed {width}x{height} canvas with {len(placements)} objects "
          f"on {device} -> {out_path}")


if __name__ == "__main__":
    main()
