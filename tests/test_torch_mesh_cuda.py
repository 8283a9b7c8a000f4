"""The multi-GPU paths on one card: a world of one over nccl (make_mesh's
own world, no torchrun), two gloo ranks both on cuda:0 (NCCL refuses two
ranks on one GPU), and ``compat.compositor.composite`` on the card. In
every rank the sharded solid render and the sharded fused render launch
K2, the sharded merge launches K1 (counts read around each), and each
equals its single-GPU run byte for byte.

Every test here is marked ``cuda`` and skips without a card:
``python -m pytest tests/test_torch_mesh_cuda.py -m cuda -q``.
"""

import pickle
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from PIL import Image

from . import torch_mesh_ranks as ranks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 have no CPU mode")
    return torch.device("cuda", 0)


def _spawn(tmp_path, world, backend):
    ctx = mp.start_processes(ranks.run_card, args=(str(tmp_path), world, backend),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the ranks did not finish in 300 s")
    out = []
    for r in range(world):
        with open(tmp_path / f"card_{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_mesh_ranks_launch_the_kernels_on_the_card(cuda, tmp_path, world, backend):
    for res in _spawn(tmp_path, world, backend):
        assert res["backend"] == backend and res["world"] == world
        assert res["solid_launches"]["fused_v3"] > 0
        assert res["fused_launches"]["fused_v3"] > 0
        assert res["merge_launches"]["fused_compose"] > 0
        assert res["solid_equal"] and res["fused_equal"] and res["merge_equal"]
        got, want = res["solid_luma"]
        assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.cuda
def test_compat_composite_launches_k1_and_equals_pil(cuda):
    from image_transformation_tpu_torch.compat import compositor
    from image_transformation_tpu_torch.core.bundle import load_bundle
    from image_transformation_tpu_torch.ops import compose_kernels as ck

    bundle = load_bundle("data/squarespace")
    bg = Image.new("RGBA", (657, 369), (40, 50, 60, 255))
    placements = [{"object_id": oid, "box": [20 * i, 10 * i, 20 * i + 150, 10 * i + 120]}
                  for i, oid in enumerate(sorted(bundle.objects))]
    ck.reset_launch_counts()
    got = np.asarray(compositor.composite(bg, bundle.objects, placements, device="cuda"))
    assert ck.LAUNCHES["fused_compose"] == 1
    want = bg.copy()
    for p in placements:
        x1, y1, x2, y2 = p["box"]
        want.alpha_composite(bundle.objects[p["object_id"]].resize((x2 - x1, y2 - y1),
                                                                   Image.LANCZOS), dest=(x1, y1))
    assert np.array_equal(got, np.asarray(want))
    cpu = np.asarray(compositor.composite(bg, bundle.objects, placements, device="cpu"))
    assert np.array_equal(got, cpu)
