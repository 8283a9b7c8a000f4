"""The sharded solid render over a mesh of GPUs.

The port of examples/05_multichip.py. make_mesh builds a (data, spatial)
mesh over the ranks of the process group: one process per GPU under
torchrun, and a world of one on ``--device`` when launched plainly. The
one-program solid render (background fill + K2 on each rank's canvases +
one all-reduce of the mean luminance) runs one step, one canvas per
``data`` rank, on small synthetic sprites as in the JAX example.

    python image_transformation_tpu_torch/examples/05_multichip.py [--device cpu]
    torchrun --nproc-per-node 4 image_transformation_tpu_torch/examples/05_multichip.py
"""
import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from image_transformation_tpu_torch.ops.compose_kernels import planarize_objects  # noqa: E402
from image_transformation_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from image_transformation_tpu_torch.parallel.sweep import (  # noqa: E402
    make_sharded_solid_render,
    random_downscale_boxes,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    H, W = 32, 64
    n_obj, pad_h, pad_w = 3, 16, 24

    # small synthetic sprites: solid-colour rectangles with ragged extents
    rng = np.random.default_rng(0)
    objs = np.zeros((n_obj, pad_h, pad_w, 4), np.uint8)
    obj_hw = np.zeros((n_obj, 2), np.int32)
    for k in range(n_obj):
        h = int(rng.integers(pad_h // 2, pad_h + 1))
        w = int(rng.integers(pad_w // 2, pad_w + 1))
        objs[k, :h, :w, :3] = rng.integers(0, 256, 3)
        objs[k, :h, :w, 3] = 255
        obj_hw[k] = (h, w)

    backend = "nccl" if torch.device(args.device).type == "cuda" else "gloo"
    mesh = make_mesh(device=args.device, backend=backend)
    try:
        B = mesh.size("data")  # one canvas per data rank
        step = make_sharded_solid_render(mesh, (H, W), (pad_h, pad_w))
        objs_p = planarize_objects(torch.from_numpy(objs)[None])  # one shared copy
        obj_hw_b = torch.from_numpy(np.broadcast_to(obj_hw, (B, n_obj, 2)).copy())
        boxes = torch.from_numpy(np.stack([
            random_downscale_boxes(rng, obj_hw, (H, W)) for _ in range(B)
        ]))
        out, luma = step(objs_p, obj_hw_b, boxes)
        shape = dict(zip(mesh.dim_names, mesh.shape))
        print(f"mesh: {shape}, this rank's output plane: {tuple(out.shape)} on "
              f"{out.device}, global mean luma (all-reduce): {float(luma[0]):.2f}")
    finally:
        mesh.close()


if __name__ == "__main__":
    main()
