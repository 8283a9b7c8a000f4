"""The port's tensor Flex solver (layout/solve.py) against the JAX package's
solve_program (CPU backend) and against the port's host oracle
layout/flex.solve_flex.

JAX's solver runs under jax.jit and jax.vmap over the canvas sizes (as the
JAX fused step runs it), with the program's arrays as arguments: every
program is padded with inert rows (the fill values from_dsl pads with) to
one shape, so one compiled solver serves the whole campaign. The port gets
the same padded program, and its unpadded one must give the same rows.

Tolerance: none. Boxes (int32) and scales (float32) must be bit-equal:
the solver is integer arithmetic, floor division, float32 fits and
banker's rounding, all of which the port reproduces operation for
operation.
"""

import json
from dataclasses import fields
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_transformation_tpu.layout import solve as jax_solve_module
from image_transformation_tpu.layout.solve import FlexProgram as JaxProgram
from image_transformation_tpu.layout.solve import solve_program as jax_solve
from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.layout import FlexProgram, solve_program
from image_transformation_tpu_torch.layout.canvas import compute_canvas_size
from image_transformation_tpu_torch.layout.flex import solve_flex

GOLDENS = json.loads((Path(__file__).parent / "goldens" / "flex_goldens.json").read_text())
RATIOS = ["9:16", "1:1", "16:9", "4:1"]
#: canvas sizes every campaign case is solved at, in one batched call
CANVASES = np.array([[492, 492], [369, 657], [657, 369], [985, 246],
                     [31, 977], [1200, 8], [640, 640], [1001, 333]], np.int32)


def _inputs(prog, sizes):
    n = prog.n_objects
    obj_wh = np.zeros((n, 2), np.int32)
    known = np.zeros((n,), bool)
    for k, oid in enumerate(prog.obj_ids):
        if int(oid) in sizes:
            obj_wh[k] = sizes[int(oid)]
            known[k] = True
    return obj_wh, known


#: (entries, containers, children per container, objects) of the padded programs
PAD = (12, 10, 8, 12)
#: from_dsl's fill value of each padded field
FILL = dict(entry_is_container=False, entry_ref=-1, cont_dir=0,
            cont_justify=jax_solve_module.J_CENTER, cont_align=jax_solve_module.A_CENTER,
            cont_gap=0, cont_pad=0, cont_children=-1, obj_ids=-1, obj_pad=0, obj_pin=0,
            obj_offset=0, obj_stick=0, obj_stick_margin=0, obj_parent_entry=-1,
            obj_parent_cont=-1)


def _padded_fields(prog):
    """The program's fields padded to PAD with inert rows."""
    E, C, K, N = PAD
    assert prog.n_entries <= E and prog.cont_children.shape[0] <= C
    assert prog.cont_children.shape[1] <= K and prog.n_objects <= N
    out = {}
    for f in fields(JaxProgram):
        a = getattr(prog, f.name)
        if f.name not in FILL:
            out[f.name] = a
            continue
        a = np.asarray(a)
        rows = {"entry": E, "cont": C, "obj": N}[f.name.split("_")[0]]
        shape = (rows, K) if f.name == "cont_children" else (rows, *a.shape[1:])
        full = np.full(shape, FILL[f.name], a.dtype)
        full[tuple(slice(0, d) for d in a.shape)] = a
        out[f.name] = full
    return out


@partial(jax.jit)
def _jax_solve(prog_fields, canvases, obj_wh, known):
    prog = JaxProgram(**prog_fields)
    return jax.vmap(lambda c: jax_solve(prog, (c[0], c[1]), obj_wh, known))(canvases)


def _check(root, sizes, canvases):
    """Solve ``root`` at every (W, H) of ``canvases`` [V, 2] in one call of
    each solver; the port must equal JAX (boxes and scales) and the oracle."""
    boxes, scales = _check_program(FlexProgram.from_dsl(root), sizes, canvases)
    for i, (W, H) in enumerate(canvases.tolist()):
        for k, p in enumerate(solve_flex(root, (W, H), sizes)):
            assert boxes[i, k].tolist() == p["box"], (json.dumps(root), (W, H), k)
    return boxes, scales


def _check_program(prog, sizes, canvases):
    """The port's solve of ``prog`` == JAX's (padded, jitted), bit for bit."""
    n = prog.n_objects
    obj_wh, known = _inputs(prog, sizes)
    boxes, scales = solve_program(prog, torch.from_numpy(canvases), obj_wh, known)
    assert boxes.dtype == torch.int32 and scales.dtype == torch.float32
    assert boxes.shape == (len(canvases), n, 4)

    padded = _padded_fields(prog)
    pad_wh = np.zeros((PAD[3], 2), np.int32)
    pad_known = np.zeros((PAD[3],), bool)
    pad_wh[:n], pad_known[:n] = obj_wh, known
    pb, ps = solve_program(FlexProgram(**padded), canvases, pad_wh, pad_known)
    jb, js = _jax_solve({k: jnp.asarray(v) for k, v in padded.items()},
                        jnp.asarray(canvases), jnp.asarray(pad_wh), jnp.asarray(pad_known))
    assert np.array_equal(pb.numpy(), np.asarray(jb)), canvases
    assert np.array_equal(ps.numpy(), np.asarray(js)), canvases
    assert torch.equal(boxes, pb[:, :n]) and torch.equal(scales, ps[:, :n])
    return boxes, scales


def test_from_dsl_arrays_equal_jax():
    roots = ([case["root"] for case in GOLDENS] + _random_roots(30, 5)[0]
             + _adversarial_roots(30, 6)[0])
    for root in roots:
        got, want = FlexProgram.from_dsl(root), JaxProgram.from_dsl(root)
        for f in fields(JaxProgram):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
            assert np.array_equal(a, b), (f.name, json.dumps(root))
        assert got.n_entries == want.n_entries and got.n_objects == want.n_objects


def test_goldens_one_canvas_and_batched():
    for case in GOLDENS:
        sizes = {int(k): tuple(v) for k, v in case["sizes"].items()}
        prog = FlexProgram.from_dsl(case["root"])
        obj_wh, known = _inputs(prog, sizes)
        W, H = case["canvas"]
        canvases = CANVASES.copy()
        canvases[0] = (W, H)
        batched, batched_scales = _check(case["root"], sizes, canvases)
        boxes, scales = solve_program(prog, (W, H), obj_wh, known)  # one (W, H): [N, 4]
        assert boxes.shape == (prog.n_objects, 4)
        assert torch.equal(boxes, batched[0]) and torch.equal(scales, batched_scales[0])
        for k, p in enumerate(case["placements"]):
            assert boxes[k].tolist() == p["box"]


@pytest.mark.parametrize("bundle_name", ["squarespace", "audio_book"])
def test_bundle_layouts_at_the_fleet_ratios(bundle_name):
    bundle = load_bundle(f"data/{bundle_name}")
    ids = bundle.object_ids()
    column = {"type": "flex", "direction": "column", "children": [
        {"object_id": oid, "name": bundle.meta[oid].label} for oid in ids]}
    grouped = {"type": "flex", "direction": "row", "justify": "space_between",
               "align": "end", "gap_px": 12, "padding_px": 10, "children": [
                   {"object_id": ids[0], "name": "a", "pin": {"horizontal": "center",
                                                             "vertical": "end"}},
                   {"type": "flex", "direction": "column", "justify": "space_around",
                    "gap_px": 7, "padding_px": 4, "children": [
                        {"object_id": oid, "name": "b", "padding_px": 9,
                         "offset_px": {"x": -13, "y": 5}} for oid in ids[1:]]}]}
    sizes = bundle.sizes()
    canvases = np.array([compute_canvas_size(bundle.background.size, r, verbose=False)
                         for r in RATIOS], np.int32)
    for root in (column, grouped):
        batched, _ = _check(root, sizes, canvases)
        # one variant per call equals its row of the batched call
        prog = FlexProgram.from_dsl(root)
        obj_wh, known = _inputs(prog, sizes)
        for i, (W, H) in enumerate(canvases.tolist()):
            one, _ = solve_program(prog, (W, H), obj_wh, known)
            assert torch.equal(one, batched[i])


def test_half_pixel_centring_rounds_half_to_even():
    """A centred object lands on k + 0.5 only where its inner slot is wider
    than the object by an odd count, which takes object paddings so negative
    that the measured size floors at 0 (the DSL rejects them, so the
    program is built by hand, as a tensor program may be). Both solvers
    round half to even, as Python's round: a floor(x + 0.5) would differ at
    every tie."""
    root = {"type": "flex", "direction": "row", "justify": "start", "children": [
        {"object_id": 1, "name": "a", "pin": {"horizontal": "center", "vertical": "center"}}]}
    canvases = np.array([[300, 200]] * 8, np.int32)
    ties = 0
    for ow in (10, 11):
        for pl, pr in ((-8, -7), (-9, -7), (-8, -8), (-12, -3)):
            for r_pad in (20, 21):
                prog = FlexProgram.from_dsl(dict(root, padding_px=r_pad))
                prog.obj_pad[0] = (pl, pr, 0, 0)
                boxes, _ = _check_program(prog, {1: (ow, 9)}, canvases)
                rem = -(pl + pr) - ow  # the slot's slack past the object
                base = r_pad + pl + rem / 2
                ties += rem % 2
                assert boxes[0, 0, 0].item() == round(base), (ow, pl, pr, r_pad)
    assert ties >= 8


def _random_roots(trials, seed):
    """The random generator of tests/test_tensor_solver.py:78 (pins, negative
    offsets, stick margins, one nested container)."""
    rng = np.random.default_rng(seed)
    justs = ["start", "center", "end", "space_between", "space_around"]
    aligns = ["start", "center", "end"]
    roots, all_sizes = [], []
    for _ in range(trials):
        n_obj = int(rng.integers(1, 6))
        sizes = {i + 1: (int(rng.integers(1, 400)), int(rng.integers(1, 300)))
                 for i in range(n_obj)}
        ids = list(sizes)
        rng.shuffle(ids)
        children, nested = [], []
        for oid in ids:
            node = {"object_id": oid, "name": f"o{oid}"}
            if rng.random() < 0.4:
                node["padding_px"] = int(rng.integers(0, 30))
            if rng.random() < 0.3:
                node["pin"] = {"horizontal": str(rng.choice(aligns))}
            if rng.random() < 0.3:
                node["offset_px"] = {"x": int(rng.integers(-50, 50)),
                                     "y": int(rng.integers(-50, 50))}
            if rng.random() < 0.2:
                node["stick_to"] = {
                    "edges": [str(rng.choice(["left", "right", "top", "bottom"]))],
                    "margin_px": int(rng.integers(0, 20)),
                }
            if rng.random() < 0.4 and len(nested) < 1:
                nested.append(node)
            else:
                children.append(node)
        if nested:
            children.insert(int(rng.integers(0, len(children) + 1)), {
                "type": "flex",
                "direction": str(rng.choice(["row", "column"])),
                "justify": str(rng.choice(justs)),
                "align": str(rng.choice(aligns)),
                "gap_px": int(rng.integers(0, 20)),
                "padding_px": int(rng.integers(0, 20)),
                "children": nested,
            })
        roots.append({
            "type": "flex",
            "direction": str(rng.choice(["row", "column"])),
            "justify": str(rng.choice(justs)),
            "align": str(rng.choice(aligns)),
            "gap_px": int(rng.integers(0, 15)),
            "padding_px": int(rng.integers(0, 15)),
            "children": children,
        })
        all_sizes.append(sizes)
    return roots, all_sizes


def _adversarial_roots(trials, seed):
    """The adversarial generator of tests/test_tensor_solver.py:153: negative
    gaps and paddings, dual-axis pins, multi-edge sticks with margins,
    unknown object ids, empty containers, several nested containers and
    unknown justify/align strings."""
    rng = np.random.default_rng(seed)
    justs = ["start", "center", "end", "space_between", "space_around", "middle", "spread"]
    aligns = ["start", "center", "end", "top", "weird"]
    edge_pairs = [["left"], ["right"], ["top"], ["bottom"],
                  ["left", "top"], ["right", "bottom"], ["left", "bottom"]]
    roots, all_sizes = [], []
    for _ in range(trials):
        n_obj = int(rng.integers(1, 7))
        sizes = {i + 1: (int(rng.integers(1, 500)), int(rng.integers(1, 400)))
                 for i in range(n_obj)}
        ids = list(sizes)
        rng.shuffle(ids)
        if rng.random() < 0.2:
            ids.append(999)  # unknown object id: zero-size row, known=False

        def leaf(oid):
            node = {"object_id": oid, "name": f"o{oid}"}
            if rng.random() < 0.5:
                node["padding_px"] = int(rng.integers(0, 40))
            if rng.random() < 0.4:
                node["pin"] = {
                    "horizontal": str(rng.choice(["start", "center", "end"])),
                    "vertical": str(rng.choice(["start", "center", "end"])),
                }
            if rng.random() < 0.4:
                node["offset_px"] = {"x": int(rng.integers(-200, 200)),
                                     "y": int(rng.integers(-200, 200))}
            if rng.random() < 0.3:
                node["stick_to"] = {
                    "edges": list(edge_pairs[int(rng.integers(0, len(edge_pairs)))]),
                    "margin_px": int(rng.integers(0, 40)),
                }
            return node

        leaves = [leaf(oid) for oid in ids]
        children = []
        k = 0
        while k < len(leaves):
            if rng.random() < 0.35:
                take = int(rng.integers(1, min(3, len(leaves) - k) + 1))
                children.append({
                    "type": "flex",
                    "direction": str(rng.choice(["row", "column"])),
                    "justify": str(rng.choice(justs)),
                    "align": str(rng.choice(aligns)),
                    "gap_px": int(rng.integers(-10, 30)),
                    "padding_px": int(rng.integers(-5, 30)),
                    "children": leaves[k:k + take],
                })
                k += take
            else:
                children.append(leaves[k])
                k += 1
        if rng.random() < 0.1:
            children.append({"type": "flex", "direction": "row", "children": []})
        roots.append({
            "type": "flex",
            "direction": str(rng.choice(["row", "column"])),
            "justify": str(rng.choice(justs)),
            "align": str(rng.choice(aligns)),
            "gap_px": int(rng.integers(-10, 25)),
            "padding_px": int(rng.integers(0, 25)),
            "children": children,
        })
        all_sizes.append(sizes)
    return roots, all_sizes


@pytest.mark.parametrize("generator,trials,seed", [
    (_random_roots, 40, 0),
    (_adversarial_roots, 80, 99),
])
def test_campaign_matches_jax_and_oracle(generator, trials, seed):
    """Each case is solved at 8 canvas sizes in one call: a few hundred
    (layout, canvas) cases per generator, bit-equal to JAX and the oracle."""
    roots, all_sizes = generator(trials, seed)
    rng = np.random.default_rng(seed + 1)
    for root, sizes in zip(roots, all_sizes):
        canvases = CANVASES.copy()
        canvases[-2:] = rng.integers(8, 1600, (2, 2))
        _check(root, sizes, canvases)


def test_device_inputs_and_cache():
    """Host arrays and tensors give the same result, and the program's
    operands are built once per device."""
    case = GOLDENS[2]
    sizes = {int(k): tuple(v) for k, v in case["sizes"].items()}
    prog = FlexProgram.from_dsl(case["root"])
    obj_wh, known = _inputs(prog, sizes)
    a = solve_program(prog, CANVASES, obj_wh, known)
    b = solve_program(prog, torch.from_numpy(CANVASES), torch.from_numpy(obj_wh),
                      torch.from_numpy(known))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert list(prog._device_cache) == ["cpu"]
