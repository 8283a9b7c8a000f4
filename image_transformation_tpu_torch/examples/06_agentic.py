"""The agentic state-machine variant, hermetically, on the GPU.

The port of examples/06_agentic.py. run_workflow compiles the macro ->
validator -> compositor -> critic -> micro graph and invokes it: the macro
persona plans a simplified Flex-DSL, the validator checks coverage, the
compositor renders without scaling (K1 on a card), and critic -> micro
cycles nudge placements through executed adjust_x/adjust_y tool calls.
install_fake_client swaps the network VLM for the canned FakeClient.

    python image_transformation_tpu_torch/examples/06_agentic.py [--device cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from image_transformation_tpu_torch.agentic.workflow import run_workflow  # noqa: E402
from image_transformation_tpu_torch.pipeline.cli import install_fake_client  # noqa: E402


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    bundle_dir = REPO / "data" / "squarespace"
    install_fake_client(bundle_dir)
    state = run_workflow(
        bundle_dir,
        ratio="9:16",
        base_run_dir=Path(tempfile.gettempdir()) / "itpu_torch_example_agentic",
        max_iterations=2,
        device=args.device,
    )
    drafts = sorted(state.run.run_root.glob("iteration_*/final_product/draft_*.png"))
    print(f"run dir: {state.run.run_root}")
    print(f"iterations: {state.iteration}, placements: {len(state.placements)}")
    print(f"agentic drafts: {[p.name for p in drafts]}")


if __name__ == "__main__":
    main()
