"""Process-group set-up of the sequence-sharded serving path."""

from .mesh import init_seq_group, make_seq_mesh

__all__ = ["init_seq_group", "make_seq_mesh"]
