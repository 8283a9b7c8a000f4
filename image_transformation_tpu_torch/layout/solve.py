# Copy of image_transformation_tpu/layout/solve.py (FlexProgram copied; solve_program ported to torch).
"""Vectorized Flex-DSL solver: layout as tensors, solved on a device.

The host oracle (layout/flex.py) recurses over the DSL dict; this module
flattens the depth<=2 tree into fixed-size integer arrays once on host
(:class:`FlexProgram`) and solves them with masked segment arithmetic in
torch (:func:`solve_program`). Canvas sizes and per-object pixel sizes are
tensor inputs, so one program re-solves a layout for any canvas or
object-size variant, and a leading variant axis [V, 2] of canvas sizes
solves V variants in one call (broadcast, where the JAX package vmaps).

Exact integer parity with the oracle and with the JAX package: floor
division (``torch.div(..., rounding_mode="floor")``, Python's ``//``),
banker's rounding (``torch.round`` on float32 operands built as JAX builds
them), int32 running sums, downscale-only fitting,
pins/offsets/stick edges, sequential clamp order, and the final
size-preserving canvas clamp. Gathers index with -1 sentinels made safe by
``max(idx, 0)``, as JAX does (a torch index of -1 would wrap).

Structure encoding (depth <= 2): the root's children are "entries" —
either a leaf object or a level-1 container whose children are all leaf
objects. Objects carry their tuning fields; containers carry
direction/justify/align/gap/padding.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

DIR_ROW, DIR_COL = 0, 1
J_START, J_CENTER, J_END, J_SPACE_BETWEEN, J_SPACE_AROUND = 0, 1, 2, 3, 4
A_START, A_CENTER, A_END = 0, 1, 2
PIN_NONE, PIN_START, PIN_CENTER, PIN_END = 0, 1, 2, 3

_JUSTIFY_CODE = {
    "start": J_START, "center": J_CENTER, "end": J_END,
    "space_between": J_SPACE_BETWEEN, "space_around": J_SPACE_AROUND,
}
_ALIGN_CODE = {"start": A_START, "center": A_CENTER, "end": A_END}
_PIN_CODE = {"start": PIN_START, "center": PIN_CENTER, "end": PIN_END}


def _justify_code(value) -> int:
    """Oracle-tolerant mapping: flex.py's _axis_cursor falls through to
    start-cursor behavior for unknown justify strings, so the tensor
    program must too (a raw KeyError here used to surface as a misleading
    "missing field" 400 from /v1/render_batch while /v1/render accepted
    the same layout)."""
    return _JUSTIFY_CODE.get(value, J_START)


def _align_code(value) -> int:
    """flex.py's _cross_position treats unknown align as center."""
    return _ALIGN_CODE.get(value, A_CENTER)


@dataclass
class FlexProgram:
    """Host-flattened layout tensors (numpy; ship to device as needed).

    Shapes: E entries, C containers, N objects (program order = DSL order =
    z-order). ``obj_slot_entry``/``obj_slot_container`` locate each object's
    slot; exactly one of them is >= 0.
    """

    # root
    root_dir: int
    root_justify: int
    root_align: int
    root_gap: int
    root_pad: int
    # entries (root children)
    entry_is_container: np.ndarray  # bool [E]
    entry_ref: np.ndarray  # int32 [E] -> object row or container row
    # containers
    cont_dir: np.ndarray  # int32 [C]
    cont_justify: np.ndarray
    cont_align: np.ndarray
    cont_gap: np.ndarray
    cont_pad: np.ndarray
    cont_children: np.ndarray  # int32 [C, K] object rows, -1 padding
    # objects (program order)
    obj_ids: np.ndarray  # int32 [N]
    obj_pad: np.ndarray  # int32 [N, 4] l, r, t, b
    obj_pin: np.ndarray  # int32 [N, 2] horizontal, vertical (PIN_*)
    obj_offset: np.ndarray  # int32 [N, 2] x, y
    obj_stick: np.ndarray  # int32 [N, 4] left, right, top, bottom flags
    obj_stick_margin: np.ndarray  # int32 [N]
    obj_parent_entry: np.ndarray  # int32 [N] entry row if root child else -1
    obj_parent_cont: np.ndarray  # int32 [N] container row if nested else -1
    # the solver's program-only operands per device (see _static)
    _device_cache: Dict[str, "_Static"] = field(
        default_factory=dict, repr=False, compare=False)

    @staticmethod
    def from_dsl(root: Dict) -> "FlexProgram":
        from .flex import sanitize_offset, sanitize_padding, sanitize_pin, sanitize_stick_to

        entries_is_c: List[bool] = []
        entries_ref: List[int] = []
        conts: List[Dict] = []
        cont_children: List[List[int]] = []
        objs: List[Dict] = []
        obj_parent_entry: List[int] = []
        obj_parent_cont: List[int] = []

        def add_object(node: Dict, entry_idx: int, cont_idx: int) -> int:
            oid = int(node.get("object_id", -1))
            pad = sanitize_padding(node.get("padding_px"), oid)
            pin = sanitize_pin(node.get("pin"), oid) if node.get("pin") is not None else {}
            off = sanitize_offset(node.get("offset_px"), oid)
            stick = (
                sanitize_stick_to(node.get("stick_to"), oid)
                if node.get("stick_to") is not None
                else {}
            )
            edges = stick.get("edges", [])
            objs.append({
                "id": oid,
                "pad": [pad["left"], pad["right"], pad["top"], pad["bottom"]],
                "pin": [
                    _PIN_CODE.get(pin.get("horizontal"), PIN_NONE),
                    _PIN_CODE.get(pin.get("vertical"), PIN_NONE),
                ],
                "offset": [off["x"], off["y"]],
                "stick": [
                    int("left" in edges), int("right" in edges),
                    int("top" in edges), int("bottom" in edges),
                ],
                "stick_margin": int(stick.get("margin_px", 0)),
            })
            obj_parent_entry.append(entry_idx)
            obj_parent_cont.append(cont_idx)
            return len(objs) - 1

        for ch in root.get("children", []) or []:
            if "object_id" in ch:
                e = len(entries_is_c)
                entries_is_c.append(False)
                entries_ref.append(add_object(ch, e, -1))
            else:
                c = len(conts)
                conts.append({
                    "dir": DIR_ROW if ch.get("direction", "row") == "row" else DIR_COL,
                    "justify": _justify_code(ch.get("justify", "center")),
                    "align": _align_code(ch.get("align", "center")),
                    "gap": int(ch.get("gap_px", 0)),
                    "pad": int(ch.get("padding_px", 0)),
                })
                kids = []
                for sub in ch.get("children", []) or []:
                    if "object_id" not in sub:
                        raise ValueError("FlexProgram requires depth <= 2")
                    kids.append(add_object(sub, -1, c))
                cont_children.append(kids)
                entries_is_c.append(True)
                entries_ref.append(c)

        E = max(1, len(entries_is_c))
        C = max(1, len(conts))
        N = max(1, len(objs))
        K = max(1, max((len(k) for k in cont_children), default=1))

        kids_arr = np.full((C, K), -1, np.int32)
        for c, kids in enumerate(cont_children):
            kids_arr[c, : len(kids)] = kids

        def pad_list(values, fill, n):
            out = list(values) + [fill] * (n - len(values))
            return np.asarray(out, np.int32)

        return FlexProgram(
            root_dir=DIR_ROW if root.get("direction", "row") == "row" else DIR_COL,
            root_justify=_justify_code(root.get("justify", "center")),
            root_align=_align_code(root.get("align", "center")),
            root_gap=int(root.get("gap_px", 0)),
            root_pad=int(root.get("padding_px", 0)),
            entry_is_container=pad_list(
                [int(b) for b in entries_is_c], 0, E
            ).astype(bool),
            entry_ref=pad_list(entries_ref, -1, E),
            cont_dir=pad_list([c["dir"] for c in conts], 0, C),
            cont_justify=pad_list([c["justify"] for c in conts], J_CENTER, C),
            cont_align=pad_list([c["align"] for c in conts], A_CENTER, C),
            cont_gap=pad_list([c["gap"] for c in conts], 0, C),
            cont_pad=pad_list([c["pad"] for c in conts], 0, C),
            cont_children=kids_arr,
            obj_ids=pad_list([o["id"] for o in objs], -1, N),
            obj_pad=np.asarray(
                [o["pad"] for o in objs] + [[0, 0, 0, 0]] * (N - len(objs)), np.int32
            ),
            obj_pin=np.asarray(
                [o["pin"] for o in objs] + [[0, 0]] * (N - len(objs)), np.int32
            ),
            obj_offset=np.asarray(
                [o["offset"] for o in objs] + [[0, 0]] * (N - len(objs)), np.int32
            ),
            obj_stick=np.asarray(
                [o["stick"] for o in objs] + [[0, 0, 0, 0]] * (N - len(objs)), np.int32
            ),
            obj_stick_margin=pad_list([o["stick_margin"] for o in objs], 0, N),
            obj_parent_entry=pad_list(obj_parent_entry, -1, N),
            obj_parent_cont=pad_list(obj_parent_cont, -1, N),
        )

    @property
    def n_entries(self) -> int:
        return len(self.entry_ref)

    @property
    def n_objects(self) -> int:
        return len(self.obj_ids)


@dataclass
class _Static:
    """The program-only operands of :func:`solve_program` on one device:
    the JAX solver's expressions that read no canvas or object size (XLA
    folds them into constants), evaluated once per (program, device)."""

    root: torch.Tensor  # int32 [4]: pad, justify, align, gap
    valid_obj: torch.Tensor  # bool [N]
    pad: torch.Tensor  # int32 [N, 4] l, r, t, b
    kid_valid: torch.Tensor  # bool [C, K]
    safe_kid: torch.Tensor  # int64 [C, K]
    cont_gap: torch.Tensor  # int32 [C]
    cont_pad: torch.Tensor  # int32 [C]
    cont_pad2: torch.Tensor  # int32 [C]
    cont_row: torch.Tensor  # bool [C]
    cont_justify: torch.Tensor  # int32 [C]
    cont_align: torch.Tensor  # int32 [C]
    e_is_c: torch.Tensor  # bool [E]
    e_ref_obj: torch.Tensor  # int64 [E]: max(ref, 0) cut at N - 1
    e_ref_cont: torch.Tensor  # int64 [E]: max(ref, 0) cut at C - 1
    e_valid: torch.Tensor  # bool [E]
    ent_of_cont: torch.Tensor  # int64 [C]
    is_root_child: torch.Tensor  # bool [N]
    safe_pe: torch.Tensor  # int64 [N]
    safe_pc: torch.Tensor  # int64 [N]
    in_cont_pos: torch.Tensor  # int64 [N]
    h_mode: torch.Tensor  # int32 [N]
    v_mode: torch.Tensor  # int32 [N]
    stick: torch.Tensor  # bool [N, 4] left, right, top, bottom
    margin: torch.Tensor  # float32 [N]
    offset: torch.Tensor  # int32 [N, 2] x, y


def _static(prog: FlexProgram, device: torch.device) -> _Static:
    """The program's :class:`_Static` on ``device``, built on the first call
    and kept on the program."""
    key = str(device)
    if key in prog._device_cache:
        return prog._device_cache[key]
    pe, pc = np.asarray(prog.obj_parent_entry), np.asarray(prog.obj_parent_cont)
    kid_idx = np.asarray(prog.cont_children)
    e_ref_raw = np.asarray(prog.entry_ref)
    e_is_c = np.asarray(prog.entry_is_container, bool)
    C, N = kid_idx.shape[0], prog.n_objects
    # the container c sits at the entry whose ref == c and is a container
    ent_of_cont = np.argmax(
        (e_ref_raw[None, :] == np.arange(C)[:, None]) & e_is_c[None, :]
        & (e_ref_raw >= 0)[None, :], axis=1)
    safe_pc = np.maximum(pc, 0)
    in_cont_pos = np.argmax(kid_idx[safe_pc] == np.arange(N)[:, None], axis=1)
    is_root_child = pe >= 0
    gov_dir = np.where(is_root_child, prog.root_dir, np.asarray(prog.cont_dir)[safe_pc])
    gov_align = np.where(is_root_child, prog.root_align, np.asarray(prog.cont_align)[safe_pc])
    # default modes: horizontal <- align if the parent is a column else start;
    # vertical <- align if the parent is a row else start
    align_pin = np.where(gov_align == A_CENTER, PIN_CENTER,
                         np.where(gov_align == A_END, PIN_END, PIN_START))
    pin_h, pin_v = np.asarray(prog.obj_pin)[:, 0], np.asarray(prog.obj_pin)[:, 1]
    h_mode = np.where(pin_h != PIN_NONE, pin_h,
                      np.where(gov_dir == DIR_COL, align_pin, PIN_START))
    v_mode = np.where(pin_v != PIN_NONE, pin_v,
                      np.where(gov_dir == DIR_ROW, align_pin, PIN_START))

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    i32, i64 = torch.int32, torch.int64
    static = _Static(
        root=t([prog.root_pad, prog.root_justify, prog.root_align, prog.root_gap], i32),
        valid_obj=t((pe >= 0) | (pc >= 0), torch.bool),
        pad=t(prog.obj_pad, i32),
        kid_valid=t(kid_idx >= 0, torch.bool),
        safe_kid=t(np.maximum(kid_idx, 0), i64),
        cont_gap=t(prog.cont_gap, i32),
        cont_pad=t(prog.cont_pad, i32),
        cont_pad2=t(2 * np.maximum(0, np.asarray(prog.cont_pad, np.int32)), i32),
        cont_row=t(np.asarray(prog.cont_dir) == DIR_ROW, torch.bool),
        cont_justify=t(prog.cont_justify, i32),
        cont_align=t(prog.cont_align, i32),
        e_is_c=t(e_is_c, torch.bool),
        # JAX's gather clamps an index past the table; the entry's own
        # table never needs it
        e_ref_obj=t(np.clip(e_ref_raw, 0, N - 1), i64),
        e_ref_cont=t(np.clip(e_ref_raw, 0, C - 1), i64),
        e_valid=t(e_ref_raw >= 0, torch.bool),
        ent_of_cont=t(ent_of_cont, i64),
        is_root_child=t(is_root_child, torch.bool),
        safe_pe=t(np.maximum(pe, 0), i64),
        safe_pc=t(safe_pc, i64),
        in_cont_pos=t(in_cont_pos, i64),
        h_mode=t(h_mode, i32),
        v_mode=t(v_mode, i32),
        stick=t(np.asarray(prog.obj_stick) > 0, torch.bool),
        margin=t(prog.obj_stick_margin, torch.float32),
        offset=t(prog.obj_offset, i32),
    )
    prog._device_cache[key] = static
    return static


def _floordiv(a, b):
    """Python's ``//`` (floor) on int32 tensors, as jnp's."""
    return torch.div(a, b, rounding_mode="floor")


def _axis_start_and_gap(justify, inner_start, inner_extent, content, n, gap):
    """Tensor replica of the oracle's justify cursor arithmetic."""
    total = content + gap * (n - 1).clamp(min=0)
    start_center = inner_start + _floordiv(inner_extent - total, 2).clamp(min=0)
    start_end = inner_start + (inner_extent - total).clamp(min=0)
    sb_applies = (justify == J_SPACE_BETWEEN) & (n > 1)
    sa_applies = (justify == J_SPACE_AROUND) & (n > 0)
    g_sb = _floordiv(inner_extent - content, (n - 1).clamp(min=1)).clamp(min=0)
    g_sa = _floordiv(inner_extent - content, n.clamp(min=1)).clamp(min=0)
    start = torch.where(
        justify == J_CENTER,
        start_center,
        torch.where(justify == J_END, start_end, inner_start),
    )
    start = torch.where(sa_applies, inner_start + _floordiv(g_sa, 2), start)
    gap_between = torch.where(sb_applies, g_sb, torch.where(sa_applies, g_sa, gap))
    return start, gap_between


def _cross_pos(align, inner_start, inner_extent, extent):
    center = inner_start + _floordiv(inner_extent - extent, 2)
    return torch.where(
        align == A_START,
        inner_start,
        torch.where(align == A_END, inner_start + (inner_extent - extent), center),
    )


def _exclusive_cumsum(steps: torch.Tensor) -> torch.Tensor:
    """int32 running sum along the last axis, starting at 0."""
    zero = torch.zeros_like(steps[..., :1])
    return torch.cat([zero, torch.cumsum(steps, dim=-1, dtype=torch.int32)[..., :-1]], dim=-1)


def solve_program(
    prog: FlexProgram,
    canvas_wh,
    obj_wh,
    obj_known,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve to clamped pixel boxes for one or many canvas sizes.

    canvas_wh: (W, H), or int [V, 2] with one (W, H) per variant;
    obj_wh: int [N, 2] = (w, h) per program object row; obj_known: bool
    [N] (False reproduces the oracle's missing-image semantics: the object
    fills its inner slot). Returns (boxes int32 [V, N, 4], scales float32
    [V, N]), or [N, 4] and [N] for one (W, H) pair, bit-equal to the JAX
    package's ``solve_program`` (under ``jax.vmap`` for [V, 2]). Runs on
    the device of ``obj_wh`` (the CPU for a host array); the other inputs
    are copied there.
    """
    dev = obj_wh.device if torch.is_tensor(obj_wh) else torch.device("cpu")
    st = _static(prog, dev)
    i32, f32 = torch.int32, torch.float32

    def on(x, dtype):
        return torch.as_tensor(x, device=dev).to(dtype)

    wh = on(canvas_wh, i32)
    single = wh.dim() == 1
    wh = wh.reshape(-1, 2)
    W, H = wh[:, 0:1], wh[:, 1:2]  # [V, 1]: every per-variant value is [V, ...]
    obj_wh = on(obj_wh, i32)
    ow, oh = obj_wh[:, 0], obj_wh[:, 1]
    pad_l, pad_r, pad_t, pad_b = st.pad.unbind(1)

    # ---- measure objects (size + 4-side padding, floored at 0) ----
    m_ow = (ow + pad_l + pad_r).clamp(min=0)
    m_oh = (oh + pad_t + pad_b).clamp(min=0)

    # ---- measure containers ----
    kid_valid = st.kid_valid
    kid_w = torch.where(kid_valid, m_ow[st.safe_kid], 0)
    kid_h = torch.where(kid_valid, m_oh[st.safe_kid], 0)
    n_kids = kid_valid.sum(dim=1, dtype=i32)
    c_gap, c_pad2 = st.cont_gap, st.cont_pad2
    gaps = c_gap * (n_kids - 1).clamp(min=0)
    m_cw = torch.where(st.cont_row, kid_w.sum(dim=1, dtype=i32) + gaps, kid_w.amax(dim=1))
    m_ch = torch.where(st.cont_row, kid_h.amax(dim=1), kid_h.sum(dim=1, dtype=i32) + gaps)
    m_cw = (m_cw + c_pad2).clamp(min=0)
    m_ch = (m_ch + c_pad2).clamp(min=0)
    # empty containers measure to (2*pad, 2*pad)
    m_cw = torch.where(n_kids == 0, c_pad2.clamp(min=0), m_cw)
    m_ch = torch.where(n_kids == 0, c_pad2.clamp(min=0), m_ch)

    # ---- entry measured sizes ----
    e_valid = st.e_valid
    e_w = torch.where(st.e_is_c, m_cw[st.e_ref_cont], m_ow[st.e_ref_obj])
    e_h = torch.where(st.e_is_c, m_ch[st.e_ref_cont], m_oh[st.e_ref_obj])
    e_w = torch.where(e_valid, e_w, 0)
    e_h = torch.where(e_valid, e_h, 0)

    # ---- place root entries ----
    r_pad, r_justify, r_align, r_gap = st.root.unbind(0)
    inner_x = inner_y = r_pad
    inner_w = (W - 2 * r_pad).clamp(min=0)
    inner_h = (H - 2 * r_pad).clamp(min=0)
    n_entries = e_valid.sum(dtype=i32)
    row = prog.root_dir == DIR_ROW
    main_extent = e_w if row else e_h
    content = torch.where(e_valid, main_extent, 0).sum(dtype=i32)
    start, gap_between = _axis_start_and_gap(
        r_justify,
        inner_x if row else inner_y,
        inner_w if row else inner_h,
        content,
        n_entries,
        r_gap,
    )
    steps = torch.where(e_valid, main_extent + gap_between, 0)  # [V, E]
    main_pos = start + _exclusive_cumsum(steps)
    cross_pos = _cross_pos(
        r_align,
        inner_y if row else inner_x,
        inner_h if row else inner_w,
        e_h if row else e_w,
    )
    e_x = main_pos if row else cross_pos
    e_y = cross_pos if row else main_pos

    # ---- place container children (slots inside their entry box) ----
    c_x0 = e_x[:, st.ent_of_cont]
    c_y0 = e_y[:, st.ent_of_cont]
    c_padv = st.cont_pad
    ci_x = c_x0 + c_padv
    ci_y = c_y0 + c_padv
    ci_w = (m_cw - 2 * c_padv).clamp(min=0)
    ci_h = (m_ch - 2 * c_padv).clamp(min=0)
    c_row = st.cont_row
    kid_main = torch.where(c_row[:, None], kid_w, kid_h)
    kid_content = torch.where(kid_valid, kid_main, 0).sum(dim=1, dtype=i32)
    c_start, c_gap_between = _axis_start_and_gap(
        st.cont_justify,
        torch.where(c_row, ci_x, ci_y),
        torch.where(c_row, ci_w, ci_h),
        kid_content,
        n_kids,
        c_gap,
    )
    kid_steps = torch.where(kid_valid, kid_main + c_gap_between[..., None], 0)  # [V, C, K]
    kid_main_pos = c_start[..., None] + _exclusive_cumsum(kid_steps)
    kid_cross_pos = _cross_pos(
        st.cont_align[:, None],
        torch.where(c_row, ci_y, ci_x)[..., None],
        torch.where(c_row, ci_h, ci_w)[:, None],
        torch.where(c_row[:, None], kid_h, kid_w),
    )
    kid_x = torch.where(c_row[:, None], kid_main_pos, kid_cross_pos)
    kid_y = torch.where(c_row[:, None], kid_cross_pos, kid_main_pos)

    # ---- gather per-object slot origin/size ----
    is_root_child, pe, pc, pos = st.is_root_child, st.safe_pe, st.safe_pc, st.in_cont_pos
    slot_x = torch.where(is_root_child, e_x[:, pe], kid_x[:, pc, pos])
    slot_y = torch.where(is_root_child, e_y[:, pe], kid_y[:, pc, pos])
    slot_w = torch.where(is_root_child, e_w[pe], kid_w[pc, pos])
    slot_h = torch.where(is_root_child, e_h[pe], kid_h[pc, pos])

    # ---- per-object placement (elementwise replica of the oracle) ----
    in_x1 = slot_x + pad_l
    in_y1 = slot_y + pad_t
    in_x2 = torch.maximum(in_x1, slot_x + slot_w - pad_r)
    in_y2 = torch.maximum(in_y1, slot_y + slot_h - pad_b)
    in_w = (in_x2 - in_x1).clamp(min=0)
    in_h = (in_y2 - in_y1).clamp(min=0)

    owf = ow.to(f32)
    ohf = oh.to(f32)
    known = on(obj_known, torch.bool) & (ow > 0) & (oh > 0)
    sw = torch.where(in_w > 0, in_w.to(f32) / owf.clamp(min=1.0), 1.0)
    sh = torch.where(in_h > 0, in_h.to(f32) / ohf.clamp(min=1.0), 1.0)
    scale = torch.minimum(sw, sh).clamp(max=1.0).clamp(min=0.0)
    t_w = torch.round(owf * scale).to(i32)
    t_h = torch.round(ohf * scale).to(i32)
    t_w = torch.where(known, t_w, in_w)
    t_h = torch.where(known, t_h, in_h)
    scale = torch.where(known, scale, 1.0)
    t_w = torch.minimum(t_w.clamp(min=0), in_w)
    t_h = torch.minimum(t_h.clamp(min=0), in_h)

    h_mode, v_mode = st.h_mode, st.v_mode
    in_x1f, in_y1f = in_x1.to(f32), in_y1.to(f32)
    rem_w = (in_w - t_w).clamp(min=0).to(f32)
    rem_h = (in_h - t_h).clamp(min=0).to(f32)
    base_x = torch.where(
        h_mode == PIN_CENTER,
        in_x1f + rem_w / 2,
        torch.where(h_mode == PIN_END, (in_x2 - t_w).to(f32), in_x1f),
    )
    base_y = torch.where(
        v_mode == PIN_CENTER,
        in_y1f + rem_h / 2,
        torch.where(v_mode == PIN_END, (in_y2 - t_h).to(f32), in_y1f),
    )

    st_l, st_r, st_t, st_b = st.stick.unbind(1)
    margin = st.margin
    base_x = torch.where(st_l, in_x1f + margin, base_x)
    base_x = torch.where(~st_l & st_r, (in_x2 - t_w).to(f32) - margin, base_x)
    base_y = torch.where(st_t, in_y1f + margin, base_y)
    base_y = torch.where(~st_t & st_b, (in_y2 - t_h).to(f32) - margin, base_y)

    base_x = base_x + st.offset[:, 0]
    base_y = base_y + st.offset[:, 1]

    max_x = torch.maximum(in_x1, in_x2 - t_w).to(f32)
    max_y = torch.maximum(in_y1, in_y2 - t_h).to(f32)
    base_x = torch.minimum(torch.maximum(base_x, in_x1f), max_x)
    base_y = torch.minimum(torch.maximum(base_y, in_y1f), max_y)

    x1 = torch.round(base_x).to(i32)  # half to even, as Python round()
    y1 = torch.round(base_y).to(i32)
    x2 = x1 + t_w
    y2 = y1 + t_h

    # sequential push-inside (right/bottom first, then left/top)
    over_r = (x2 - in_x2).clamp(min=0)
    x1, x2 = x1 - over_r, x2 - over_r
    under_l = (in_x1 - x1).clamp(min=0)
    x1, x2 = x1 + under_l, x2 + under_l
    over_b = (y2 - in_y2).clamp(min=0)
    y1, y2 = y1 - over_b, y2 - over_b
    under_t = (in_y1 - y1).clamp(min=0)
    y1, y2 = y1 + under_t, y2 + under_t

    # final canvas clamp (size preserving)
    w_box = x2 - x1
    h_box = y2 - y1
    x1 = torch.minimum(x1, W - w_box).clamp(min=0)
    y1 = torch.minimum(y1, H - h_box).clamp(min=0)
    boxes = torch.stack([x1, y1, x1 + w_box, y1 + h_box], dim=-1)
    boxes = torch.where(st.valid_obj[:, None], boxes, 0).to(i32)
    scale = scale.expand(boxes.shape[:-1])
    if single:
        return boxes[0], scale[0]
    return boxes, scale.contiguous()
