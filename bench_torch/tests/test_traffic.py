"""The traffic generator repeats per seed and varies across seeds."""

import json

import numpy as np

from bench_torch import traffic

BIG = 2**31 + 12345  # a run's seed may pass 32 signed bits
OBJ_HW = np.array([[62, 230], [207, 357], [137, 257], [32, 131]])
SPACING = {"gap_max": 48, "padding_max": 24}


def _all(seed):
    rng = np.random.default_rng(seed)
    return (traffic.box_pool(rng, OBJ_HW, (1920, 1080), 3, 5),
            json.dumps(traffic.unique_layouts(rng, [1, 2, 3, 4], 200, SPACING)),
            traffic.poisson_arrivals(rng, 100.0, 2.0),
            traffic.zipf_indices(rng, 1024, 1.0, 500))


def test_generators_repeat_per_seed_and_differ_across_seeds():
    a, b, c = _all(BIG), _all(BIG), _all(BIG + 1)
    for x, y in zip(a, b):
        assert np.array_equal(x, y) if not isinstance(x, str) else x == y
    assert not np.array_equal(a[0], c[0]) and a[1] != c[1]


def test_boxes_are_downscales_inside_the_canvas():
    pool = traffic.box_pool(np.random.default_rng(BIG), OBJ_HW, (1920, 1080), 4, 64)
    w, h = pool[..., 2] - pool[..., 0], pool[..., 3] - pool[..., 1]
    assert (pool[..., :2] >= 0).all() and (pool[..., 2] <= 1080).all() and (pool[..., 3] <= 1920).all()
    assert (w <= OBJ_HW[None, None, :, 1]).all() and (h <= OBJ_HW[None, None, :, 0]).all()
    assert (w >= 1).all() and (h >= 1).all()


def test_layouts_are_distinct_depth_two_trees_over_object_subsets():
    docs = traffic.unique_layouts(np.random.default_rng(BIG), [1, 2, 3], 300, SPACING)
    keys = {json.dumps(d, sort_keys=True) for d in docs}
    assert len(keys) == 300
    for d in docs:
        ids = []
        for ch in d["root"]["children"]:
            if "object_id" in ch:
                ids.append(ch["object_id"])
            else:
                assert all("object_id" in g for g in ch["children"])  # depth <= 2
                ids += [g["object_id"] for g in ch["children"]]
        assert ids and len(set(ids)) == len(ids) and set(ids) <= {1, 2, 3}


def test_arrivals_hold_the_rate_and_zipf_favours_low_ranks():
    t = traffic.poisson_arrivals(np.random.default_rng(BIG), 200.0, 50.0)
    assert abs(len(t) / 50.0 - 200.0) < 10 and (np.diff(t) > 0).all() and t[-1] < 50.0
    z = traffic.zipf_indices(np.random.default_rng(BIG), 1024, 1.0, 20000)
    assert (z == 0).mean() > 5 * (z == 9).mean() > 0
