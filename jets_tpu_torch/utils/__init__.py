from . import tree

__all__ = ["tree"]
