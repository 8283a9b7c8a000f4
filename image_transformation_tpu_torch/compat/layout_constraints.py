"""The reference layout_constraints API on the port.

Counterpart of the root ``layout_constraints.py``: the canvas math and the
legacy grid/flow helpers under the reference's names and signatures
(host code, ``layout.canvas`` and ``layout.legacy``).
"""

from ..layout.canvas import (  # noqa: F401
    GRID_CELLS,
    CellName,
    compute_canvas_size,
    grid_cells,
    parse_ratio,
)
from ..layout.canvas import cell_row_col as _cell_row_col  # noqa: F401
from ..layout.legacy import (  # noqa: F401
    ObjectMeta,
    Placement,
    baseline_cell_assignments,
    finalize_layout,
    layout_final_json,
    pack_flow,
)
from ..layout.legacy import load_object_meta as _load_object_meta  # noqa: F401
