# Copy of image_transformation_tpu/ui/agentic_app.py (imports rewritten to this package; main takes the device of its runs).
"""Streamlit UI for the agentic (state-machine) pipeline.

Parity: the reference's agentic/app.py — sidebar key/ratio/temperature/
micro-iteration controls, three persona models (macro at T, micro at
T-0.1, critic at 0.2), compile+invoke, then per-iteration artifact
expanders. The workflow's compositor runs on the device ``main`` is given
("cuda" by default: K1 on a card; "cpu" runs its plain version). Run
headlessly: python -m image_transformation_tpu_torch.ui.headless agentic
"""

from __future__ import annotations

from pathlib import Path

try:
    import streamlit as st
except ImportError:  # pragma: no cover
    st = None

REPO_ROOT = Path(__file__).resolve().parents[2]


def main(device: str = "cuda") -> None:
    if st is None:
        raise RuntimeError("streamlit is not installed; the agentic pipeline is "
                           "available programmatically via "
                           "image_transformation_tpu_torch.agentic.run_workflow")

    from image_transformation_tpu_torch.agentic.workflow import run_workflow
    from image_transformation_tpu_torch.pipeline.cli import install_fake_client
    from image_transformation_tpu_torch.vlm.client import register_fake_client

    st.set_page_config(page_title="Agentic Macro Placement (GPU)", layout="wide")
    st.title("Agentic Macro Placement — PyTorch/CUDA")

    st.sidebar.header("Connection")
    backend = st.sidebar.selectbox("VLM backend", ["nebius", "ollama", "fake (hermetic)"])
    api_key = st.sidebar.text_input("Nebius API Key", type="password")

    st.sidebar.header("Parameters")
    col_w, col_h = st.sidebar.columns(2)
    with col_w:
        ratio_w = st.number_input("Ratio W", 1, 100, 9)
    with col_h:
        ratio_h = st.number_input("Ratio H", 1, 100, 16)
    ratio = f"{ratio_w}:{ratio_h}"
    temperature = st.sidebar.slider("Temperature", 0.0, 1.2, 0.7, 0.1)
    max_iterations = st.sidebar.slider("Micro iterations", 0, 10, 2, 1)

    bundle_root = REPO_ROOT / "data"
    bundles = (
        sorted(
            p.name for p in bundle_root.iterdir()
            if (p / "results.json").exists()
        )
        if bundle_root.exists()
        else []
    )
    if not bundles:
        st.warning(f"No segmentation bundles found under {bundle_root}.")
        return
    bundle_name = st.selectbox("Bundle", bundles)

    if st.button("Run agentic workflow") and bundle_name:
        bundle_dir = bundle_root / bundle_name
        api_type = backend
        if backend == "fake (hermetic)":
            install_fake_client(bundle_dir)
            api_type = "auto"
        elif backend == "nebius" and not api_key:
            st.error("Please enter a Nebius API key.")
            st.stop()
        status = st.empty()
        status.info("Running agentic workflow…")
        try:
            state = run_workflow(
                bundle_dir=bundle_dir,
                ratio=ratio,
                base_run_dir=REPO_ROOT / "output_agentic",
                api_type=api_type,
                api_key=api_key or None,
                temperature=temperature,
                max_iterations=max_iterations,
                device=device,
            )
            status.success(f"Done after iteration {state.iteration}.")
            st.session_state["agentic_run"] = str(state.run.run_root)
        except Exception as e:
            status.error(f"Run failed: {e}")
        finally:
            register_fake_client(None)

    run_root = st.session_state.get("agentic_run")
    if run_root:
        run_root = Path(run_root)
        for it_dir in sorted(run_root.glob("iteration_*")):
            with st.expander(it_dir.name, expanded=True):
                draft = next(iter((it_dir / "final_product").glob("*.png")), None)
                if draft:
                    st.image(str(draft), caption=draft.name)
                for sub in ("vlm_output", "layout_json", "vlm_input_text"):
                    for f in sorted((it_dir / sub).glob("*")):
                        if f.suffix in {".txt", ".json"}:
                            st.caption(f"{sub}/{f.name}")
                            st.code(f.read_text(encoding="utf-8")[:4000])


if __name__ == "__main__":
    main()
