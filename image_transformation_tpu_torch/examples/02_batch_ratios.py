"""Several aspect-ratio variants in ONE fused device pass.

The port of examples/02_batch_ratios.py. ComposeService.render_batch builds
(and caches) one step that solves the layout on the device, makes each
variant's background and runs the fused resize + alpha-over kernel K2 for
every requested ratio at once: the throughput path behind the
/v1/render_batch endpoint.

    python image_transformation_tpu_torch/examples/02_batch_ratios.py [--device cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from PIL import Image  # noqa: E402

from image_transformation_tpu_torch.serving import ComposeService  # noqa: E402


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    out_dir = Path(tempfile.gettempdir())
    service = ComposeService(REPO / "data", device=args.device,
                             manifest_path=out_dir / "itpu_torch_example_steps.json")
    renders = service.render_batch("squarespace", ["9:16", "1:1", "16:9"])
    for ratio, (canvas_size, boxes, img) in renders.items():
        path = out_dir / f"itpu_torch_example_batch_{ratio.replace(':', 'x')}.png"
        Image.fromarray(img, "RGBA").save(path)
        print(f"{ratio}: {canvas_size[0]}x{canvas_size[1]}, "
              f"{len(boxes)} boxes -> {path}")


if __name__ == "__main__":
    main()
