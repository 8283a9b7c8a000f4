"""The port's vectorized validator (layout/validate_vec.py) against the JAX
package's (CPU backend, jitted and vmapped as its own tests run it) and
against the host validator (layout/validate.py, the port's copy).

Tolerance: none. The masks are integer arithmetic on host-quantized
extents, so every mask, count and flag must be equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_transformation_tpu.layout import validate_vec as jvv
from image_transformation_tpu.layout.solve import FlexProgram as JaxProgram
from image_transformation_tpu_torch.core.bundle import load_bundle
from image_transformation_tpu_torch.layout.flex import FlexError
from image_transformation_tpu_torch.layout.solve import FlexProgram
from image_transformation_tpu_torch.layout.validate import (
    compute_nesting_conflicts,
    validate_flex_dsl,
)
from image_transformation_tpu_torch.layout.validate_vec import (
    conflict_masks,
    conflict_masks_from_extents,
    coverage_check,
    inner_extents,
    pair_structure,
    validate_program,
    validate_program_extents,
)

_jax_masks = jax.jit(jvv.conflict_masks_from_extents)


def _host_masks(labels, sizes, canvas, margin):
    """Index-space bool masks from the host label-pair lists."""
    row_bad, col_bad = compute_nesting_conflicts(labels, sizes, canvas, margin)
    n = len(labels)
    row = np.zeros((n, n), bool)
    col = np.zeros((n, n), bool)
    for pairs, mask in ((row_bad, row), (col_bad, col)):
        for a, b in pairs:
            i, j = labels.index(a), labels.index(b)
            mask[i, j] = mask[j, i] = True
    return row, col


def _campaign(trials, seed):
    """The bit-exact campaign of tests/test_validate_vec.py:73: random
    canvas/margin/size draws, decimal margins, margins whose products sit
    on integers, and sizes on the single and pair-sum thresholds."""
    rng = np.random.default_rng(seed)
    for trial in range(trials):
        n = int(rng.integers(2, 8))
        canvas = (int(rng.integers(50, 4000)), int(rng.integers(50, 4000)))
        kind = trial % 3
        if kind == 0:
            margin = float(rng.uniform(0, 0.45))
        elif kind == 1:
            margin = float(rng.choice([0.01, 0.05, 0.07, 0.1, 0.125, 0.2]))
        else:
            margin = int(rng.integers(1, 20)) / (2.0 * canvas[0])
        inner = jvv.inner_extents(canvas, margin)
        sizes = []
        for _ in range(n):
            if rng.random() < 0.5:
                base = int(inner[0 if rng.random() < 0.5 else 1])
                sizes.append((max(1, base + int(rng.integers(-1, 2))),
                              max(1, base // 2 + int(rng.integers(-1, 2)))))
            else:
                sizes.append((int(rng.integers(1, 2000)), int(rng.integers(1, 2000))))
        yield [f"o{i}" for i in range(n)], sizes, canvas, margin


def test_inner_extents_equal_jax():
    canvases = [(369, 657), (985, 246), (500, 500), (3999, 51)]
    margins = [0.0, 0.05, 0.07, 0.2, 0.3, 1 / 738]
    for canvas in canvases:
        for margin in margins:
            got = inner_extents(canvas, margin)
            assert got.dtype == np.int32
            assert np.array_equal(got, jvv.inner_extents(canvas, margin))
        sweep = inner_extents(canvas, np.asarray(margins))
        assert np.array_equal(sweep, jvv.inner_extents(canvas, np.asarray(margins)))


def test_conflict_masks_bit_exact_campaign():
    """Masks equal JAX's (jitted) and the host validator's on 150 draws."""
    for labels, sizes, canvas, margin in _campaign(150, 7):
        wh = np.asarray(sizes, np.int32)
        ext = inner_extents(canvas, margin)
        row, col = conflict_masks(torch.from_numpy(wh), canvas, margin)
        assert row.dtype == torch.bool and row.shape == (len(sizes),) * 2
        jrow, jcol = _jax_masks(jnp.asarray(wh), jnp.asarray(ext))
        host_row, host_col = _host_masks(labels, sizes, canvas, margin)
        assert np.array_equal(row.numpy(), np.asarray(jrow)), (sizes, canvas, margin)
        assert np.array_equal(col.numpy(), np.asarray(jcol)), (sizes, canvas, margin)
        assert np.array_equal(row.numpy(), host_row), (sizes, canvas, margin)
        assert np.array_equal(col.numpy(), host_col), (sizes, canvas, margin)


def test_conflict_masks_on_bundles_over_a_margin_sweep():
    """A [K, 3] extents table gives K mask pairs in one call, equal to JAX's
    vmap over the table and to the host validator margin by margin."""
    margins = np.asarray([0.0, 0.05, 0.1, 0.2, 0.3], np.float32)
    for name in ("squarespace", "audio_book"):
        bundle = load_bundle(f"data/{name}")
        ids = bundle.object_ids()
        labels = [bundle.meta[oid].label for oid in ids]
        sizes = [tuple(bundle.sizes()[oid]) for oid in ids]
        wh = np.asarray(sizes, np.int32)
        for canvas in ((369, 657), (985, 246), (500, 500)):
            ext = inner_extents(canvas, margins)
            row, col = conflict_masks_from_extents(wh, ext)
            jrow, jcol = jax.vmap(lambda e: _jax_masks(jnp.asarray(wh), e))(jnp.asarray(ext))
            assert row.shape == (len(margins), len(ids), len(ids))
            assert np.array_equal(row.numpy(), np.asarray(jrow))
            assert np.array_equal(col.numpy(), np.asarray(jcol))
            for k, m in enumerate(margins):
                host_row, host_col = _host_masks(labels, sizes, canvas, float(m))
                assert np.array_equal(row[k].numpy(), host_row), (name, canvas, m)
                assert np.array_equal(col[k].numpy(), host_col), (name, canvas, m)


def _roots():
    yield {"type": "flex", "direction": "row", "children": [
        {"object_id": 1, "name": "a"},
        {"type": "flex", "direction": "column", "children": [
            {"object_id": 2, "name": "b"}, {"object_id": 3, "name": "c"}]},
    ]}
    yield {"type": "flex", "direction": "column", "children": [
        {"type": "flex", "direction": "row", "children": [
            {"object_id": 3, "name": "c"}, {"object_id": 1, "name": "a"}]},
        {"type": "flex", "direction": "column", "children": []},
        {"object_id": 2, "name": "b"},
        {"object_id": 4, "name": "d"},
    ]}


def test_pair_structure_equal_jax():
    for root in _roots():
        got = pair_structure(FlexProgram.from_dsl(root))
        want = jvv.pair_structure(JaxProgram.from_dsl(root))
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


def test_coverage_check_equal_jax():
    cases = [
        ([1, 2, 3], [True] * 3, [1, 2, 3]),
        ([1, 2, 2], [True] * 3, [1, 2, 3]),
        ([1, 2, 9], [True] * 3, [1, 2, 3]),
        ([1, 2, 3, 0], [True, True, True, False], [1, 2, 3]),
        ([5, 5, 5, 7], [True, True, False, True], [5, 6]),
    ]
    for ids, valid, required in cases:
        got = coverage_check(torch.tensor(ids), valid, required)
        want = jvv.coverage_check(jnp.asarray(ids), jnp.asarray(valid), jnp.asarray(required))
        for key in ("covered", "missing", "duplicates", "unknown"):
            assert got[key].item() == np.asarray(want[key]).item(), (ids, key)


def test_validate_program_matches_jax_and_the_host_validator():
    """The grouping case the host validator rejects is flagged with the same
    pair count by both vectorized validators; a clean layout passes."""
    labels = {1: "logo", 2: "photo"}
    sizes = np.array([[300, 60], [340, 200]], np.int32)  # wide pair
    canvas, margin = (500, 500), 0.05
    root = {"type": "flex", "direction": "row", "children": [
        {"object_id": 1, "name": "logo"},
        {"type": "flex", "direction": "column",
         "children": [{"object_id": 2, "name": "photo"}]},
    ]}
    row_bad, col_bad = compute_nesting_conflicts(
        ["logo", "photo"], [tuple(s) for s in sizes], canvas, margin)
    with pytest.raises(FlexError, match="non-nestable pair via grouping"):
        validate_flex_dsl({"root": root}, [1, 2], labels,
                          row_bad_pairs={frozenset(p) for p in row_bad},
                          col_bad_pairs={frozenset(p) for p in col_bad})
    for r in (root, dict(root, direction="column")):
        got = validate_program(FlexProgram.from_dsl(r), torch.from_numpy(sizes), canvas,
                               margin, [1, 2])
        want = jvv.validate_program(JaxProgram.from_dsl(r), jnp.asarray(sizes), canvas,
                                    margin, jnp.asarray([1, 2]))
        assert {k: v.item() for k, v in got.items()} == {
            k: np.asarray(v).item() for k, v in want.items()}
    res = validate_program(FlexProgram.from_dsl(root), sizes, canvas, margin, [1, 2])
    assert res["covered"].item() and not res["ok"].item()
    assert res["n_row_violations"].item() == 1 and res["n_col_violations"].item() == 0


def test_validate_program_over_a_margin_sweep_equals_jax_vmap():
    bundle = load_bundle("data/audio_book")
    ids = bundle.object_ids()
    labels = [bundle.meta[oid].label for oid in ids]
    sizes = [tuple(bundle.sizes()[oid]) for oid in ids]
    wh = np.asarray(sizes, np.int32)
    margins = np.asarray([0.0, 0.05, 0.1, 0.2, 0.3], np.float32)
    extents = inner_extents((985, 246), margins)
    for root in [{"type": "flex", "direction": d, "children": [
            {"object_id": oid, "name": bundle.meta[oid].label} for oid in ids]}
            for d in ("row", "column")] + [{"type": "flex", "direction": "row", "children": [
            {"object_id": ids[0], "name": "x"},
            {"type": "flex", "direction": "column", "children": [
                {"object_id": oid, "name": "y"} for oid in ids[1:]]}]}]:
        got = validate_program_extents(FlexProgram.from_dsl(root), wh, extents, ids)
        jprog = JaxProgram.from_dsl(root)
        want = jax.jit(jax.vmap(lambda e: jvv.validate_program_extents(
            jprog, jnp.asarray(wh), e, jnp.asarray(ids))))(jnp.asarray(extents))
        for key, value in got.items():
            assert value.shape == (len(margins),), key
            assert np.array_equal(value.numpy(), np.asarray(want[key])), key
        if root["direction"] == "row" and len(root["children"]) == len(ids):
            for k, m in enumerate(margins):
                host_row, _ = _host_masks(labels, sizes, (985, 246), float(m))
                assert got["n_row_violations"][k].item() == int(np.triu(host_row, 1).sum())
