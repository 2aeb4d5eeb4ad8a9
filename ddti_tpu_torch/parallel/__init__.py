"""Data and spatial parallelism of the port: the mesh and its collectives
(``mesh.py``), the band ops of the ``model`` axis (``spatial.py``) and
the multi-process launch (``multihost.py``)."""

from .mesh import (  # noqa: F401
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
