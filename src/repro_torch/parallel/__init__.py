"""Sharding of the port: the logical-axis rules and specs, the meshes, and
the collectives of a mesh axis (`sharding`)."""

from .sharding import (DEFAULT_RULES, AbstractMesh, Mesh, MeshAxis, MeshRules,
                       P, SeqGroup, constrain, make_rules, overrides_for)

__all__ = ["DEFAULT_RULES", "AbstractMesh", "Mesh", "MeshAxis", "MeshRules",
           "P", "SeqGroup", "constrain", "make_rules", "overrides_for"]
