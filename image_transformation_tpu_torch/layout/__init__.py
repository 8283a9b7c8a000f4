"""The port's layout package (counterpart of image_transformation_tpu/layout/)."""

from .canvas import (
    GRID_CELLS,
    compute_canvas_size,
    grid_cells,
    parse_ratio,
    ratio_family,
)
from .flex import FlexError, measure_node, place_tree, solve_flex
from .solve import FlexProgram, solve_program
from .validate import (
    compute_nesting_conflicts,
    extract_json_maybe,
    parse_flex_response,
    validate_flex_dsl,
)
