"""Process-group set-up of the sharded serving paths."""

from .mesh import (init_mesh_group, init_seq_group, make_mesh,
                   make_production_mesh, make_seq_mesh)

__all__ = ["init_mesh_group", "init_seq_group", "make_mesh",
           "make_production_mesh", "make_seq_mesh"]
