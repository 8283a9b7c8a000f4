# Copy of image_transformation_tpu/core/config.py (RunConfig gains ``device``; run_with_config calls this package's run_macro_only).
"""Run configuration as a single dataclass (SURVEY.md §5 config note).

Preserves the reference's CLI flag names and defaults (ratio, align in
{center, edge}, margin 0.05, api, temperature 1.0, refine-iters 10,
samples) while giving programmatic callers one typed object instead of a
dozen keyword arguments. ``device`` names where the pixel work runs
("cuda" by default, which raises without a card; "cpu").
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Optional


@dataclass
class RunConfig:
    ratio: str
    align: str = "center"
    margin: float = 0.05
    api_type: str = "auto"
    samples: int = 1
    temperature: float = 1.0
    refine_iters: int = 10
    api_key: Optional[str] = None
    original_input_path: Optional[str] = None
    planner_addendum: str = ""
    refiner_addendum: str = ""
    planner_custom_design_rules: Optional[str] = None
    critic_custom_design_rules: Optional[str] = None
    refiner_custom_design_rules: Optional[str] = None
    base_output_root: Optional[Path] = None
    resume: bool = False
    device: str = "cuda"

    def to_dict(self) -> dict:
        """The persisted form: the JAX package's keys (``device`` is where
        this process runs, not part of the run's configuration)."""
        d = asdict(self)
        if d.get("base_output_root") is not None:
            d["base_output_root"] = str(d["base_output_root"])
        d.pop("api_key", None)  # never persist credentials
        d.pop("device", None)
        return d


def run_with_config(output_dir: Path, config: RunConfig) -> Path:
    """Typed entry point over pipeline.run.run_macro_only, on
    ``config.device``."""
    from ..pipeline.run import run_macro_only

    return run_macro_only(
        output_dir,
        config.ratio,
        config.align,
        config.margin,
        api_type=config.api_type,
        samples=config.samples,
        temperature=config.temperature,
        refine_iters=config.refine_iters,
        original_input_path=config.original_input_path,
        api_key=config.api_key,
        planner_addendum=config.planner_addendum,
        refiner_addendum=config.refiner_addendum,
        planner_custom_design_rules=config.planner_custom_design_rules,
        critic_custom_design_rules=config.critic_custom_design_rules,
        refiner_custom_design_rules=config.refiner_custom_design_rules,
        base_output_root=config.base_output_root,
        resume=config.resume,
        device=config.device,
    )
