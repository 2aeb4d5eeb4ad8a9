"""Data parallelism of the port: the mesh and its collectives
(``mesh.py``) and the multi-process launch (``multihost.py``)."""

from .mesh import (  # noqa: F401
    ITEM_12B,
    Mesh,
    check_mesh_shape,
    local_rows,
    make_mesh,
    parse_mesh_spec,
)
from .multihost import (  # noqa: F401
    MultihostSpec,
    initialize_multihost,
    launch_local,
    process_local_batch,
    spec_from,
)
