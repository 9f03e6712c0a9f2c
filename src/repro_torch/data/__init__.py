from .pipeline import SyntheticLM, make_batch

__all__ = ["SyntheticLM", "make_batch"]
