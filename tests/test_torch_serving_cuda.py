"""The serving and agentic paths on the card: the engine's merged compose
(compose_many, one K1 call over B canvases), ``composite_exact`` and
``composite_canvas_tables_indexed`` (K1, upscaling boxes included), and
concurrent /v1/render against the CPU service, all byte-equal to the same
calls on the CPU (K1's plain version).

Every test here is marked ``cuda`` and skips without a card:
``python -m pytest tests/test_torch_serving_cuda.py -m cuda -q``.
"""

import concurrent.futures
import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.ops import compose_kernels as ck
from image_transformation_tpu_torch.ops.compose import (
    composite_canvas_tables_indexed,
    composite_exact,
)
from image_transformation_tpu_torch.ops.resize import build_coeffs_host
from image_transformation_tpu_torch.serving import ComposeService, serve


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    return torch.device("cuda", 0)


def _services(tmp_path, device):
    return (ComposeService("data", tmp_path / "cuda.json", device=device),
            ComposeService("data", tmp_path / "cpu.json", device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 4, 8])
def test_compose_many_on_the_card_equals_cpu(cuda, tmp_path, batch):
    card, cpu = _services(tmp_path, cuda)
    rng = np.random.default_rng(batch)
    full, canvas_size = cpu.solve("squarespace", "9:16")
    sets = []
    for _ in range(batch):
        keep = [p for p in full if rng.random() < 0.8] or full[:1]
        shift = int(rng.integers(0, 30))
        sets.append([{**p, "box": [v + shift for v in p["box"]]} for p in keep])
    engines = [svc._engine("squarespace", canvas_size, "solid") for svc in (card, cpu)]
    ck.reset_launch_counts()
    got = engines[0].compose_many(sets)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fused_compose"] == 1  # one K1 call for the merge
    want = engines[1].compose_many(sets)
    assert torch.equal(got.cpu(), want)
    assert engines[0].measure_device_ms(sets, reps=4) > 0.0


@pytest.mark.cuda
def test_composite_exact_launches_k1_and_equals_cpu(cuda):
    bundle = load_bundle("data/squarespace")
    arrays = bundle.to_arrays()
    objs = torch.from_numpy(arrays.objects)
    canvas = torch.full((300, 420, 4), 200, dtype=torch.uint8)
    oh, ow = (int(v) for v in arrays.obj_hw[0])
    boxes = np.array([
        [10, 12, 10 + ow // 2, 12 + oh // 3],         # downscale
        [5, 40, 5 + 2 * ow, 40 + int(1.5 * oh)],      # upscale past the pad
        [200, 100, 200 + ow, 100 + oh],               # identity
        [-3, 5, 60, 70],                              # dropped (negative origin)
    ])
    idx = [0, 0, 0, 1]
    obj_hw = arrays.obj_hw[idx]
    want = composite_exact(canvas, objs[idx], obj_hw, boxes)
    ck.reset_launch_counts()
    got = composite_exact(canvas.to(cuda), objs[idx].to(cuda), obj_hw, boxes)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fused_compose"] == 1
    assert torch.equal(got.cpu(), want)
    assert not torch.equal(want, canvas)


@pytest.mark.cuda
def test_composite_canvas_tables_indexed_launches_k1(cuda):
    bundle = load_bundle("data/audio_book")
    arrays = bundle.to_arrays()
    n_obj, ph, pw = arrays.objects.shape[:3]
    mh, mw = ph + 64, pw + 96  # an envelope past the pad: upscales fit
    boxes = np.array([[4, 6, 4 + pw + 60, 6 + ph // 2], [30, 20, 90, 20 + ph + 50]])
    perm = [n_obj - 1, 0]
    kh = np.stack([build_coeffs_host(int(arrays.obj_hw[k][1]), int(b[2] - b[0]), pw, mw)
                   for k, b in zip(perm, boxes)])
    kv = np.stack([build_coeffs_host(int(arrays.obj_hw[k][0]), int(b[3] - b[1]), ph, mh)
                   for k, b in zip(perm, boxes)])
    canvas = torch.full((500, 700, 4), 90, dtype=torch.uint8)
    canvas[..., 3] = 255
    args = (perm, boxes, torch.from_numpy(kh), torch.from_numpy(kv), [False, False])
    want = composite_canvas_tables_indexed(canvas, torch.from_numpy(arrays.objects), *args)
    ck.reset_launch_counts()
    got = composite_canvas_tables_indexed(canvas.to(cuda),
                                          torch.from_numpy(arrays.objects).to(cuda), *args)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fused_compose"] == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_concurrent_http_renders_on_the_card_equal_cpu(cuda, tmp_path):
    card, cpu = _services(tmp_path, cuda)
    daemon = serve("data", port=0, service=card)
    thread = threading.Thread(target=daemon.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{daemon.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz") as r:
            assert torch.cuda.get_device_name(cuda) in json.loads(r.read())["device"]
        requests = [{"bundle": "squarespace", "ratio": "9:16",
                     "layout": {"root": {"type": "flex", "direction": d, "gap_px": g,
                                         "children": [{"object_id": i} for i in ids]}}}
                    for d in ("column", "row") for g in (0, 7, 19)
                    for ids in ([1, 2, 3, 4], [4, 2], [3, 1, 2])]

        def one(req):
            data = json.dumps(req).encode()
            with urllib.request.urlopen(urllib.request.Request(
                    base + "/v1/render", data=data, method="POST")) as r:
                return np.asarray(Image.open(io.BytesIO(r.read())).convert("RGBA"))

        ck.reset_launch_counts()
        with concurrent.futures.ThreadPoolExecutor(max_workers=16) as pool:
            outs = list(pool.map(one, requests * 3))
        torch.cuda.synchronize()
        assert ck.LAUNCHES["fused_compose"] > 0
        for req, out in zip(requests * 3, outs):
            want = cpu.render(req["bundle"], req["ratio"], req["layout"])[2]
            assert np.array_equal(out, want)
    finally:
        daemon.shutdown()
        daemon.server_close()
        thread.join(timeout=60)
        for t in threading.enumerate():
            if t.name == "coalescer-drain":
                t.join(60)
