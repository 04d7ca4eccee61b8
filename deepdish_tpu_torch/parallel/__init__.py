from .grid import GridEngine, make_grid_mesh  # noqa: F401
from .multistream import MultiStreamEngine, make_mesh  # noqa: F401
from .temporal import TemporalChunkEngine  # noqa: F401
