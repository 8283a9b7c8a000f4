"""The full macro-placement iterate loop, hermetically, on the GPU.

The port of examples/03_pipeline_fake_vlm.py. run_macro_only drives
planner -> validate -> solve -> compose (K1 on a card), then critic ->
refiner cycles, writing the reference-parity artifact tree per iteration.
install_fake_client swaps the network VLM for a canned FakeClient, so the
loop runs without credentials or network.

    python image_transformation_tpu_torch/examples/03_pipeline_fake_vlm.py [--device cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from image_transformation_tpu_torch.pipeline.cli import install_fake_client  # noqa: E402
from image_transformation_tpu_torch.pipeline.run import run_macro_only  # noqa: E402


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    bundle_dir = REPO / "data" / "squarespace"
    install_fake_client(bundle_dir)
    run_dir = run_macro_only(
        bundle_dir,
        ratio="9:16",
        align="center",
        margin=0.05,
        refine_iters=2,
        base_output_root=Path(tempfile.gettempdir()) / "itpu_torch_example_pipeline",
        device=args.device,
    )
    drafts = sorted(run_dir.glob("iteration_*/final_product/draft_*.png"))
    print(f"run dir: {run_dir}")
    print(f"composed drafts: {[p.name for p in drafts]}")
    print(f"timing log: {(run_dir / 'time_log.txt').exists()}")


if __name__ == "__main__":
    main()
