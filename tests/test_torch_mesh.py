"""The port's multi-GPU paths (parallel/mesh.py, the sharded steps of
parallel/sweep.py and pipeline/fused.py, run_fleet(mesh=)) against the JAX
package's sharded steps on its virtual 8-device CPU mesh.

One spawn of 4 gloo ranks on the CPU (tests/torch_mesh_ranks.py, which
imports no jax) runs every case once for this module; rank 0 gathers the
sharded results. The JAX references run here, on 4 of the 8 virtual
devices, on the workload of tests/test_multichip_deep.py:31-67. Canvases
and boxes must be equal; the luminance is held within rtol 1e-5 (the JAX
step sums in another order: pmean / a masked mean over the mesh).
"""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
from PIL import Image

from image_transformation_tpu.layout.solve import FlexProgram
from image_transformation_tpu.parallel import mesh as jm
from image_transformation_tpu.parallel import sweep as js
from image_transformation_tpu.pipeline import fused as jf

from . import torch_mesh_ranks as ranks

SPAWN_SECONDS = 300


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case's port result, from one spawn of 4 gloo ranks."""
    tmp = tmp_path_factory.mktemp("mesh")
    ctx = mp.start_processes(ranks.run, args=(str(tmp),), nprocs=ranks.WORLD, join=False,
                             start_method="spawn")
    import time

    deadline = time.monotonic() + SPAWN_SECONDS
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the 4 ranks did not finish in {SPAWN_SECONDS} s")
    with open(tmp / "results.pkl", "rb") as f:
        results = pickle.load(f)
    results["_tmp"] = tmp
    return results


def _case(port, name):
    got = port[name]
    assert "error" not in got, got.get("error")
    return got


def _devices(n=ranks.WORLD):
    return jax.devices()[:n]


def _jax_fused(mesh, v, masked=False, bg=ranks.BG, **opts):
    root, objs, obj_wh, known = ranks.workload()
    wh = ranks.mixed_sizes(v)
    args = [jnp.asarray(wh), jnp.asarray(bg), jnp.asarray(objs), jnp.asarray(obj_wh),
            jnp.asarray(known)]
    if masked:
        axes = opts.get("batch_axes", ("data",))
        wh, valid = jf.pad_ragged_variants(wh, int(np.prod([mesh.shape[a] for a in axes])))
        args[0] = jnp.asarray(wh)
        args.append(jnp.asarray(valid))
    step = jf.make_sharded_fused_render(mesh, FlexProgram.from_dsl(root),
                                        (ranks.H_MAX, ranks.W_MAX), (ranks.PAD_H, ranks.PAD_W),
                                        masked=masked, **opts)
    with mesh:
        out, boxes, luma = step(*args)
    return np.asarray(out), np.asarray(boxes), np.asarray(luma)


FUSED = {
    "fused_data4": lambda: _jax_fused(jm.make_mesh(_devices()), 8),
    # K2's plain version per rank against JAX's sharded XLA step
    "fused_data4_pallas": lambda: _jax_fused(jm.make_mesh(_devices()), 8),
    "fused_data2_spatial2": lambda: _jax_fused(jm.make_mesh(_devices(), spatial=2), 4,
                                               spatial=True),
    "fused_slice2_data2": lambda: _jax_fused(jm.make_slice_mesh(_devices()), 8,
                                             batch_axes=("slice", "data")),
    "fused_ragged6_data4": lambda: _jax_fused(jm.make_mesh(_devices()), 6, masked=True),
    "fused_ragged6_slice": lambda: _jax_fused(jm.make_slice_mesh(_devices()), 6, masked=True,
                                              batch_axes=("slice", "data")),
    "fused_gradient_data4": lambda: _jax_fused(jm.make_mesh(_devices()), 8, bg=ranks.BG_GRAD,
                                               background="gradient"),
}


@pytest.mark.parametrize("case", sorted(FUSED))
def test_sharded_fused_render_matches_jax(port, case):
    got = _case(port, case)
    out, boxes, luma = FUSED[case]()
    assert got["out"].shape == out.shape and np.array_equal(got["out"], out)
    assert np.array_equal(got["boxes"], boxes)
    np.testing.assert_allclose(got["luma"], luma, rtol=1e-5)


def test_ragged_masked_luma_is_the_real_variants_mean(port):
    """The masked luma is the mean over the 6 real variants of the single
    step: the 2 padding legs never enter it."""
    root, objs, obj_wh, known = ranks.workload()
    step = jf.make_fused_render(FlexProgram.from_dsl(root), (ranks.H_MAX, ranks.W_MAX),
                                (ranks.PAD_H, ranks.PAD_W))
    ref = step(jnp.asarray(ranks.mixed_sizes(6)), jnp.asarray(ranks.BG), jnp.asarray(objs),
               jnp.asarray(obj_wh), jnp.asarray(known))
    for case in ("fused_ragged6_data4", "fused_ragged6_slice"):
        got = _case(port, case)
        assert np.array_equal(got["out"][:6], np.asarray(ref[0]))
        np.testing.assert_allclose(got["luma"][0], np.mean(np.asarray(ref[3])), rtol=1e-5)


def _jax_solid(batch, **opts):
    from image_transformation_tpu.ops.compose_pallas import planarize_objects

    render = js.make_sharded_solid_render(jm.make_mesh(_devices()), (ranks.H_MAX, ranks.W_MAX),
                                          (ranks.PAD_H, ranks.PAD_W), interpret=True, **opts)
    out, luma = render(planarize_objects(jnp.asarray(batch[0])), jnp.asarray(batch[1]),
                       jnp.asarray(batch[2]))
    return np.asarray(out), np.asarray(luma)


def _solid_batches():
    _, objs, obj_wh, _ = ranks.workload()
    return ranks.solid_batch(objs, obj_wh, ranks.WORLD * 2), obj_wh


@pytest.mark.parametrize("case", ["solid_data4", "solid_static_data4", "solid_two_bundles"])
def test_sharded_solid_render_matches_jax(port, case):
    """Dry-run steps 2, 5 (per-object windows) and 6 (a 2-bundle batch):
    K2's plain version per rank == JAX's gen-3 kernel under shard_map
    (interpret mode), padded planes and all."""
    (single, mixed), obj_wh = _solid_batches()
    opts = {}
    if case == "solid_static_data4":
        opts["static_obj_hw"] = tuple((int(h), int(w)) for w, h in obj_wh)
    out, luma = _jax_solid(mixed if case == "solid_two_bundles" else single, **opts)
    got = _case(port, case)
    assert got["out"].shape == out.shape and np.array_equal(got["out"], out)
    np.testing.assert_allclose(got["luma"], luma, rtol=1e-5)


def test_sharded_merge_matches_jax_and_the_engine(port):
    """Dry-run step 7: the serving merge split over 4 ranks (K1's plain
    version per rank) == JAX's sharded composite_canvas_tables_indexed_many
    == each set's sequential engine compose."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from image_transformation_tpu.core.bundle import BundleArrays
    from image_transformation_tpu.ops.compose import composite_canvas_tables_indexed_many
    from image_transformation_tpu.pipeline.engine import ComposeEngine

    got = _case(port, "merge_data4")
    _, objs, obj_wh, _ = ranks.workload()
    arrays = BundleArrays(objects=objs, obj_hw=obj_wh[:, ::-1].astype(np.int32).copy(),
                          object_ids=np.array([1, 2, 3], np.int32), n_valid=ranks.N_OBJ)
    engine = ComposeEngine(arrays, ranks.merge_canvas())
    lives = [engine.validate_placements(ps) for ps in ranks.merge_sets(ranks.WORLD * 2)]
    per = [engine._indexed_args_np(live, ranks.N_OBJ) for live in lives]
    stacked = [np.stack([a[i] for a in per]) for i in range(5)]
    for a, b in zip(got["stacked"], stacked):  # the port engine's arguments are JAX's
        assert a.dtype == b.dtype and np.array_equal(a, b)
    mesh = jm.make_mesh(_devices())
    batch, repl = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
    many = jax.jit(composite_canvas_tables_indexed_many,
                   in_shardings=(repl, repl) + (batch,) * 5, out_shardings=batch,
                   static_argnames=("wide",))
    want = np.asarray(many(jnp.asarray(ranks.merge_canvas()), jnp.asarray(objs),
                           *map(jnp.asarray, stacked)))
    assert np.array_equal(got["out"], want)
    assert np.array_equal(got["engine"], want)
    for i, live in enumerate(lives):
        assert np.array_equal(got["out"][i], np.asarray(engine.compose(live)))


@pytest.mark.parametrize("case,spatial", [("compose_step_data4", 1),
                                          ("compose_step_spatial2", 2)])
def test_sharded_compose_step_matches_jax(port, case, spatial):
    (single, _), _ = _solid_batches()
    canvases = np.zeros((ranks.WORLD * 2, ranks.H_MAX, ranks.W_MAX, 4), np.uint8)
    canvases[..., :3] = (20, 140, 200)
    canvases[..., 3] = 255
    step = js.sharded_compose_step(jm.make_mesh(_devices(), spatial=spatial),
                                   (ranks.PAD_H, ranks.PAD_W), spatial=spatial > 1)
    out, luma = step(*(jnp.asarray(x) for x in (canvases, *single)))
    got = _case(port, case)
    assert np.array_equal(got["out"], np.asarray(out))
    np.testing.assert_allclose(got["luma"], np.asarray(luma), rtol=1e-5)


def test_throughput_sweep_mesh_matches_jax(port):
    from image_transformation_tpu.core.bundle import load_bundle

    got = _case(port, "sweep_data4")
    want = js.throughput_sweep([load_bundle(b) for b in ranks.BUNDLES], ["1:1", "16:9"],
                               ranks.WORLD, ranks.SWEEP_BUDGET, mesh=jm.make_mesh(_devices()),
                               warmup=0, reps=1)
    assert got["total_canvases"] == want["total_canvases"] == 2 * ranks.WORLD
    assert got["ratios"] == {r: {k: v[k] for k in ("canvas", "batch", "superbatch")}
                             for r, v in want["ratios"].items()}
    assert got["canvases_per_sec"] > 0


def _tree(base: Path):
    return sorted(str(p.relative_to(base)) for p in base.rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def jax_fleet(tmp_path_factory):
    from image_transformation_tpu.pipeline.fleet import run_fleet

    out = tmp_path_factory.mktemp("jax_fleet")
    summary = run_fleet([Path(b) for b in ranks.BUNDLES], ranks.FLEET_RATIOS, output_root=out,
                        mesh=jm.make_mesh(_devices()), pixel_budget_size=ranks.FLEET_BUDGET)
    return out, summary


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_run_fleet_mesh_matches_jax(port, jax_fleet, kernel):
    """run_fleet(mesh=) over 4 ranks, 3 ratios padded to 4: rank 0 writes
    JAX's mesh fleet's tree; boxes and layouts equal, PNGs equal ("xla",
    JAX's sharded XLA step) or within 1 ("pallas", K2's plain version:
    JAX's own cross-program envelope, tests/test_fused_render.py:106)."""
    got = _case(port, f"fleet_data4_{kernel}")
    a, summary = jax_fleet
    b = port["_tmp"] / f"fleet_{kernel}"
    assert _tree(a) == _tree(b)
    assert got["devices"] == summary["devices"] == ranks.WORLD
    assert got["total_canvases"] == summary["total_canvases"]
    for stem in ("squarespace", "audio_book"):
        assert got["canvas_sizes"][stem] == summary["bundles"][stem]["canvas_sizes"]
        for f in ("boxes.json", "fleet_layout_used.json"):
            assert json.loads((a / stem / f).read_text()) == json.loads((b / stem / f).read_text())
        for r in ranks.FLEET_RATIOS:
            name = f"variant_{r.replace(':', 'x')}.png"
            x = np.asarray(Image.open(a / stem / name)).astype(int)
            y = np.asarray(Image.open(b / stem / name)).astype(int)
            assert x.shape == y.shape
            assert np.abs(x - y).max() <= (0 if kernel == "xla" else 1), (stem, name)


def test_mesh_shapes_and_errors_match_jax(port):
    got = _case(port, "mesh_errors")
    devs = _devices()
    want = {}
    for name, fn in (
        ("data3", lambda: jm.make_mesh(devs, data=3)),
        ("slices3", lambda: jm.make_slice_mesh(devs, slices=3)),
        ("slice3x2", lambda: jm.make_slice_mesh(devs, slices=3, data=2)),
        ("spatial_dim0", lambda: jm.shard_batched(jm.make_mesh(devs), spatial_dim=0)),
    ):
        with pytest.raises(ValueError) as e:
            fn()
        want[name] = str(e.value)
        assert got[name] == want[name]
    # a backend is never switched: the gloo world refuses a mesh over nccl
    assert "never switched" in got["nccl_on_cpu"]
    for key, mesh in (("default", jm.make_mesh(devs)), ("spatial2", jm.make_mesh(devs, spatial=2)),
                      ("slice", jm.make_slice_mesh(devs))):
        assert got["shapes"][key] == [list(mesh.axis_names), list(mesh.devices.shape)]
