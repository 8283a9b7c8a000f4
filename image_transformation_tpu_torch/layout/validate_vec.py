# Copy of image_transformation_tpu/layout/validate_vec.py (host parts copied; tensor parts ported to torch).
"""Vectorized constraint validator: conflict masks + coverage bitsets.

Tensor replica of the host validator's *data* checks
(layout/validate.py; reference anchors macro_placement_test.py:388-634):
the structural walk (types, whitelists, sanitize stripping) stays host-side
where the DSL dict lives, but everything that depends on *sizes* — the
pairwise nesting-conflict precomputation and the cross-child conflict
check — plus the object-id coverage test is integer tensor arithmetic
here, on the device of the sizes, broadcast over a leading axis of
canvas/margin variants (pairs with layout/solve.solve_program, which solves
the same FlexProgram).

Layout structure is static per program, so the pair topology (which
container direction governs each leaf pair) is precomputed once on host
(`pair_structure`); object sizes are tensors. The margin->inner-extent
quantization is BIT-EXACT vs the host validator by construction: the
host computes it in Python float64 with trailing `int()` truncation
(validate.py:346-349), so :func:`inner_extents` replicates exactly that
in host numpy f64, and the tensor side (:func:`conflict_masks_from_extents`)
is pure int32 arithmetic with no float rounding to diverge. A margin sweep
precomputes its extents table [K, 3] once and passes it whole.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .solve import DIR_ROW, FlexProgram


def inner_extents(canvas_wh, margin_pct) -> np.ndarray:
    """Margin-inset extents `[inner_w, inner_h, min_gap]`, int32 — the
    EXACT host quantization of validate.compute_nesting_conflicts
    (reference macro_placement_test.py:587-634): IEEE-double products with
    trailing truncation toward zero, so device masks built from these are
    bit-identical to the host validator's, boundary cases included.

    Host-side numpy (requires concrete values). Broadcasts: pass a margin
    array of shape [K] to get a [K, 3] table for a sweep, and pass it whole
    to :func:`conflict_masks_from_extents` / :func:`validate_program_extents`
    (they broadcast over its leading axes).
    """
    try:
        w = np.asarray(canvas_wh[0], np.float64)
        h = np.asarray(canvas_wh[1], np.float64)
        m = np.asarray(margin_pct, np.float64)
    except Exception as e:  # device tensors that cannot become host values
        raise TypeError(
            "inner_extents needs concrete canvas/margin values (the "
            "quantization contract is host float64); for sweeps "
            "precompute the extents table host-side and "
            "pass it to conflict_masks_from_extents / validate_program_extents"
        ) from e
    inner_w = np.maximum(1, (w - 2.0 * (m * w)).astype(np.int64))
    inner_h = np.maximum(1, (h - 2.0 * (m * h)).astype(np.int64))
    min_gap = np.maximum(8, (np.minimum(w, h) * 0.01).astype(np.int64))
    return np.stack(
        np.broadcast_arrays(inner_w, inner_h, min_gap), axis=-1
    ).astype(np.int32)


def _tensor(x, dtype, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(dtype)


def conflict_masks_from_extents(
    obj_wh,
    extents,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise nesting-conflict masks from sizes + precomputed extents
    (pure int32 — bit-exact vs the host validator).

    Pair (i, j) cannot share a row when either width fills the
    margin-inset canvas or their sum plus the minimum gap overflows it;
    heights dual for columns (reference macro_placement_test.py:587-634).

    obj_wh: int [N, 2] (w, h); extents: int [..., 3] from
    :func:`inner_extents`, placed on ``obj_wh``'s device. Returns
    (row_bad, col_bad) bool [..., N, N] (symmetric, diagonal False), one
    pair of masks per row of ``extents``.
    """
    obj_wh = _tensor(obj_wh, torch.int32)
    extents = _tensor(extents, torch.int32, obj_wh.device)
    inner_w, inner_h, min_gap = extents[..., 0], extents[..., 1], extents[..., 2]
    w = obj_wh[:, 0]
    h = obj_wh[:, 1]
    n = w.shape[0]
    off_diag = ~torch.eye(n, dtype=torch.bool, device=obj_wh.device)

    def axis_bad(extent, inner):
        single = extent >= inner[..., None]
        pair_sum = extent[:, None] + extent[None, :] + min_gap[..., None, None]
        bad = single[..., :, None] | single[..., None, :] | (pair_sum > inner[..., None, None])
        return bad & off_diag

    return axis_bad(w, inner_w), axis_bad(h, inner_h)


def conflict_masks(
    obj_wh,
    canvas_wh,
    margin_pct,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convenience wrapper: host-exact extents + the int masks.

    canvas_wh / margin_pct must be host values (see :func:`inner_extents`).
    """
    return conflict_masks_from_extents(
        obj_wh, inner_extents(canvas_wh, margin_pct)
    )


def pair_structure(prog: FlexProgram) -> Tuple[np.ndarray, np.ndarray]:
    """Static pair topology of a program: (pair_is_row [N, N] bool,
    pair_checked [N, N] bool).

    For two distinct leaves the governing container is the root when they
    sit under different root entries (a bad pair split across groups still
    violates — the reference's cross-child cartesian check), or their
    shared level-1 container otherwise; ``pair_is_row`` holds that
    container's direction. Host numpy — the structure is static per
    program, only sizes are tensors.
    """
    pe = np.asarray(prog.obj_parent_entry)
    pc = np.asarray(prog.obj_parent_cont)
    valid = (pe >= 0) | (pc >= 0)
    n = len(pe)

    # entry index of each object (its own entry, or its container's entry)
    ent_of_cont = np.zeros(len(prog.cont_dir), np.int64)
    for e, (is_c, ref) in enumerate(zip(prog.entry_is_container, prog.entry_ref)):
        if is_c and ref >= 0:
            ent_of_cont[ref] = e
    entry = np.where(pe >= 0, pe, ent_of_cont[np.maximum(pc, 0)])

    same_entry = entry[:, None] == entry[None, :]
    same_cont = (pc[:, None] == pc[None, :]) & (pc[:, None] >= 0)
    gov_is_row = np.where(
        same_entry & same_cont,
        (np.asarray(prog.cont_dir)[np.maximum(pc, 0)] == DIR_ROW)[:, None],
        prog.root_dir == DIR_ROW,
    )
    checked = (
        valid[:, None] & valid[None, :] & ~np.eye(n, dtype=bool)
    )
    return gov_is_row, checked


def coverage_check(
    obj_ids,
    obj_valid,
    required_ids,
) -> Dict[str, torch.Tensor]:
    """Exact-once coverage as bitset arithmetic.

    obj_ids: int [N] (program rows; padding rows have valid False);
    required_ids: int [M]. Returns 0-dim tensors: ``covered`` (every
    required id appears exactly once), ``duplicates``, ``missing``,
    ``unknown`` (valid rows whose id is not required). Runs on the device
    of ``obj_ids`` when it is a tensor.
    """
    obj_ids = _tensor(obj_ids, torch.int32)
    required = _tensor(required_ids, torch.int32, obj_ids.device)
    valid = _tensor(obj_valid, torch.bool, obj_ids.device)
    hits = (obj_ids[:, None] == required[None, :]) & valid[:, None]  # [N, M]
    counts = hits.sum(dim=0, dtype=torch.int32)  # per required id
    missing = (counts == 0).sum(dtype=torch.int32)
    duplicates = (counts - 1).clamp(min=0).sum(dtype=torch.int32)
    unknown = (valid & ~hits.any(dim=1)).sum(dtype=torch.int32)
    covered = (missing == 0) & (duplicates == 0) & (unknown == 0)
    return {
        "covered": covered,
        "missing": missing,
        "duplicates": duplicates,
        "unknown": unknown,
    }


def validate_program_extents(
    prog: FlexProgram,
    obj_wh,
    extents,
    required_ids,
) -> Dict[str, torch.Tensor]:
    """Full tensor validation of one program over its variants.

    Combines the conflict masks with the program's static pair topology and
    the coverage bitset. Returns tensors of ``extents``'s leading shape
    (0-dim for one [3] row): ``ok``, ``covered``, ``n_row_violations``,
    ``n_col_violations`` (each unordered violating pair counted once, as
    the host validator reports them), and the coverage counts. Bit-exact
    vs the host validator (the masks are integer-only; see
    :func:`inner_extents`). Runs on the device of ``obj_wh``.
    """
    row_bad, col_bad = conflict_masks_from_extents(obj_wh, extents)
    dev = row_bad.device
    gov_is_row, checked = pair_structure(prog)
    gov_is_row = torch.as_tensor(gov_is_row, device=dev)
    upper = torch.as_tensor(np.triu(checked, k=1), device=dev)
    row_viol = upper & gov_is_row & row_bad
    col_viol = upper & ~gov_is_row & col_bad
    valid = (
        (np.asarray(prog.obj_parent_entry) >= 0)
        | (np.asarray(prog.obj_parent_cont) >= 0)
    )
    cov = coverage_check(torch.as_tensor(np.asarray(prog.obj_ids), device=dev), valid,
                         required_ids)
    n_row = row_viol.sum(dim=(-2, -1), dtype=torch.int32)
    n_col = col_viol.sum(dim=(-2, -1), dtype=torch.int32)
    return {
        "ok": cov["covered"] & (n_row == 0) & (n_col == 0),
        "covered": cov["covered"].expand(n_row.shape),
        "missing": cov["missing"].expand(n_row.shape),
        "duplicates": cov["duplicates"].expand(n_row.shape),
        "unknown": cov["unknown"].expand(n_row.shape),
        "n_row_violations": n_row,
        "n_col_violations": n_col,
    }


def validate_program(
    prog: FlexProgram,
    obj_wh,
    canvas_wh,
    margin_pct,
    required_ids,
) -> Dict[str, torch.Tensor]:
    """Convenience wrapper of :func:`validate_program_extents` for one
    host canvas/margin (the quantization happens host-side; see
    :func:`inner_extents` for the sweep form)."""
    return validate_program_extents(
        prog, obj_wh, inner_extents(canvas_wh, margin_pct), required_ids
    )
