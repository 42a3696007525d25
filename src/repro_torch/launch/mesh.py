"""Thin re-export shim — the mesh layer lives in
``repro_torch.dist.mesh``."""

from repro_torch.dist.mesh import (  # noqa: F401
    data_axes,
    dp_size,
    make_production_mesh,
    solver_mesh,
)
