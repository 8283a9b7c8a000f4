# Copy of image_transformation_tpu/ui/app.py (imports rewritten to this package; main takes the device of its runs).
"""Streamlit UI for the macro-placement pipeline (main app).

Feature parity with the reference Streamlit app (its app.py):
sidebar connection (session-only Nebius key) and parameters (ratio W/H,
align, margin, temperature, refine iterations), image picker with
thumbnails over configurable input/bundle folders, three persona
design-rule text areas pre-filled from the aspect-family defaults, a run
button driving run_macro_only synchronously, and an artifact browser
(iteration slider, capped draft display, JSON/prompt/critic/raw/validation
expanders, timing log).

Additions: a "fake (hermetic)" backend choice so the UI runs end to end
without network, and a resume toggle. The pipeline runs on the device
``main`` is given ("cuda" by default: the compose is K1 on a card; "cpu"
runs its plain version); no widget chooses it.

Run headlessly: python -m image_transformation_tpu_torch.ui.headless main
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List

try:
    import streamlit as st
except ImportError:  # pragma: no cover - environment without the UI extra
    st = None
from PIL import Image as PILImage

REPO_ROOT = Path(__file__).resolve().parents[2]

from image_transformation_tpu_torch.layout.canvas import ratio_family
from image_transformation_tpu_torch.pipeline.run import run_macro_only
from image_transformation_tpu_torch.vlm.personas import best_practices_text


def _list_inputs(input_dir: Path) -> List[Path]:
    if not input_dir.exists():
        return []
    return [
        p for p in sorted(input_dir.iterdir())
        if p.suffix.lower() in {".png", ".jpg", ".jpeg"}
    ]


def _list_bundles(bundle_root: Path) -> List[Path]:
    if not bundle_root.exists():
        return []
    return [
        p for p in sorted(bundle_root.iterdir())
        if (p / "results.json").exists()
    ]


def main(device: str = "cuda") -> None:
    if st is None:
        raise RuntimeError(
            "streamlit is not installed; install it to use the UI "
            "(the pipeline CLI works without it: python -m "
            "image_transformation_tpu_torch.pipeline.cli)"
        )
    st.set_page_config(page_title="Macro Placement (GPU)", layout="wide")

    st.sidebar.header("Connection")
    backend = st.sidebar.selectbox(
        "VLM backend", ["nebius", "ollama", "fake (hermetic)"], index=0
    )
    api_key = st.sidebar.text_input(
        "Nebius API Key", type="password", help="Stored only in this session."
    )
    if api_key:
        st.sidebar.success("API key ready for this session.")

    st.sidebar.header("Parameters")
    col_w, col_h = st.sidebar.columns(2)
    with col_w:
        ratio_w = st.number_input("Ratio W", min_value=1, max_value=100, value=9)
    with col_h:
        ratio_h = st.number_input("Ratio H", min_value=1, max_value=100, value=16)
    ratio = f"{ratio_w}:{ratio_h}"

    align = st.sidebar.radio("Align", options=["center", "edge"], index=0)
    margin = st.sidebar.slider("Margin (0-0.3)", 0.0, 0.3, 0.05, 0.01)
    temperature = st.sidebar.slider("Temperature", 0.0, 1.2, 1.0, 0.1)
    refine_iters = st.sidebar.slider("Refine iterations", 0, 10, 2, 1)
    resume = st.sidebar.checkbox("Resume from last iteration", value=False)

    st.title("Macro Placement — PyTorch/CUDA")

    left_col, right_col = st.columns([3, 1])
    with right_col:
        st.subheader("Folders")
        images_folder = st.text_input(
            "Images folder name",
            value=st.session_state.get("images_folder_name", "input"),
            help="Folder (under the repo) with original images.",
        )
        bundle_folder = st.text_input(
            "Segmentation bundle folder name",
            value=st.session_state.get("bundle_folder_name", "data"),
            help="Folder (under the repo) with per-image segmentation bundles.",
        )
        st.session_state["images_folder_name"] = images_folder.strip() or "input"
        st.session_state["bundle_folder_name"] = bundle_folder.strip() or "data"

    input_dir = REPO_ROOT / st.session_state["images_folder_name"]
    bundle_root = REPO_ROOT / st.session_state["bundle_folder_name"]

    with left_col:
        choices = _list_inputs(input_dir)
        bundles = _list_bundles(bundle_root)
        names = [p.stem for p in choices] or [p.name for p in bundles]
        if not names:
            st.warning(f"No inputs in {input_dir} and no bundles in {bundle_root}.")
        if (
            "selected_stem" not in st.session_state
            or st.session_state["selected_stem"] not in names
        ):
            st.session_state["selected_stem"] = names[0] if names else None

        if choices:
            thumb_cols = st.columns(2)
            for idx, p in enumerate(choices):
                with thumb_cols[idx % 2]:
                    st.image(str(p), use_container_width=True)
                    if st.button(f"Use {p.name}", key=f"select_{p.name}"):
                        st.session_state["selected_stem"] = p.stem
        elif bundles:
            st.session_state["selected_stem"] = st.selectbox(
                "Bundle", [p.name for p in bundles],
            )

        selected_stem = st.session_state.get("selected_stem")
        if selected_stem:
            st.success(f"Selected: {selected_stem}")

    st.subheader("Design Rules (Custom Guiding Principles)")
    st.caption(
        "Customize the design rules below; leave empty to use aspect-family "
        "defaults. Object data, constraints and the DSL schema are added "
        "automatically."
    )
    defaults = best_practices_text(ratio_family(ratio))
    rules = {}
    for persona in ("planner", "critic", "refiner"):
        key = f"{persona}_custom_design_rules"
        if not st.session_state.get(key):
            st.session_state[key] = defaults
        rules[persona] = st.text_area(
            f"{persona.capitalize()} design rules",
            value=st.session_state[key],
            height=150,
        )
        st.session_state[key] = rules[persona]

    run_clicked = st.button("Run macro placement")
    status_box = st.empty()

    if run_clicked:
        selected_stem = st.session_state.get("selected_stem")
        bundle = bundle_root / (selected_stem or "")
        if backend == "nebius" and not api_key:
            st.error("Please enter a Nebius API key in the sidebar.")
        elif not selected_stem:
            st.error("Please select an input image or bundle.")
        elif not (bundle / "results.json").exists():
            st.error(f"Missing segmentation bundle at {bundle}.")
        else:
            api_type = backend
            if backend == "fake (hermetic)":
                from image_transformation_tpu_torch.pipeline.cli import install_fake_client

                install_fake_client(bundle)
                api_type = "auto"
            original = None
            for ext in (".png", ".jpg", ".jpeg"):
                cand = input_dir / f"{selected_stem}{ext}"
                if cand.exists():
                    original = str(cand)
                    break
            status_box.info("Running… this can take a few minutes depending on iterations.")
            try:
                run_macro_only(
                    output_dir=bundle,
                    ratio=ratio,
                    align=align,
                    margin=margin,
                    api_type=api_type,
                    temperature=temperature,
                    refine_iters=refine_iters,
                    original_input_path=original,
                    api_key=api_key or None,
                    planner_custom_design_rules=rules["planner"].strip() or None,
                    critic_custom_design_rules=rules["critic"].strip() or None,
                    refiner_custom_design_rules=rules["refiner"].strip() or None,
                    base_output_root=REPO_ROOT / "output_macro_placement",
                    resume=resume,
                    device=device,
                )
                st.session_state["has_run"] = True
                st.session_state["iter_idx"] = 0
                status_box.success("Run completed.")
            except Exception as e:  # surface to the user, as the reference does
                status_box.error(f"Run failed: {e}")
            finally:
                if backend == "fake (hermetic)":
                    # the fake registration is PROCESS-global: without this
                    # a later real-backend run (any session on this server)
                    # would silently receive canned fake output
                    from image_transformation_tpu_torch.vlm.client import (
                        register_fake_client,
                    )

                    register_fake_client(None)

    _artifact_browser(st.session_state.get("selected_stem"))


def _artifact_browser(selected_stem) -> None:
    if not (selected_stem and st.session_state.get("has_run", False)):
        return
    base_out = REPO_ROOT / "output_macro_placement" / selected_stem
    iterations = (
        sorted(p for p in base_out.iterdir() if p.is_dir() and p.name.startswith("iteration_"))
        if base_out.exists()
        else []
    )
    if not iterations:
        st.info("No run artifacts yet. Configure parameters and click Run.")
        return

    idx_max = len(iterations) - 1
    iter_idx = int(st.session_state.get("iter_idx", 0))
    iter_idx = 0 if not (0 <= iter_idx <= idx_max) else iter_idx
    cur = iterations[iter_idx]
    fp, vi, vo, lj = (
        cur / "final_product", cur / "vlm_input_text",
        cur / "vlm_output", cur / "layout_json",
    )

    img_main = fp / f"draft_macro_iter_{iter_idx:02d}.png"
    if img_main.exists():
        try:
            iw, ih = PILImage.open(img_main).size
        except Exception:
            iw, ih = 1000, 1000
        scale = min(1.0, 1000 / float(max(1, max(iw, ih))))
        _c1, _c2, _c3 = st.columns([1, 2, 1])
        with _c2:
            st.image(str(img_main), caption=img_main.name, width=max(1, int(iw * scale)))
    else:
        st.info("No composed image for this iteration (likely no-change).")

    if idx_max > 0:
        st.slider("Iteration", 0, idx_max, iter_idx, key="iter_idx")
    else:
        # real Streamlit rejects st.slider(min=0, max=0); a 0-refine run
        # has exactly one iteration, so there is nothing to slide
        st.caption("Single iteration run.")

    with st.expander("JSON artifacts"):
        tabs = st.tabs(["VLM layout JSON", "Final placements JSON", "Retry (if any)"])
        for tab, path in zip(
            tabs,
            [
                vo / f"layout_flex_iter_{iter_idx:02d}.json",
                lj / f"layout_macro_iter_{iter_idx:02d}.json",
                vo / f"layout_flex_iter_{iter_idx:02d}_retry.json",
            ],
        ):
            with tab:
                if path.exists():
                    try:
                        st.json(json.loads(path.read_text(encoding="utf-8")), expanded=False)
                    except Exception:
                        st.code(path.read_text(encoding="utf-8"), language="json")
                else:
                    st.info("Not available.")

    for title, path in [
        ("Planner prompt", vi / "prompt_flex.txt"),
        ("Refiner prompt", vi / f"prompt_refine_iter_{iter_idx:02d}.txt"),
        ("Refiner prompt (retry)", vi / f"prompt_refine_iter_{iter_idx:02d}_retry.txt"),
        ("Critic statement", vo / f"critic_raw_iter_{iter_idx:02d}.txt"),
        ("VLM raw output", vo / f"vlm_raw_iter_{iter_idx:02d}.txt"),
        ("Validation errors", vi / f"flex_validation_error_iter_{iter_idx:02d}.txt"),
    ]:
        with st.expander(title):
            if path.exists():
                st.code(path.read_text(encoding="utf-8"), language="text")
            else:
                st.info("Not available.")

    tl = base_out / "time_log.txt"
    if tl.exists():
        with st.expander("Timing log"):
            st.code(tl.read_text(encoding="utf-8"), language="text")


if __name__ == "__main__":
    main()
