"""Collectives over the port's 1-D sequence mesh (`sharding.SeqGroup`)."""

from .sharding import SeqGroup

__all__ = ["SeqGroup"]
