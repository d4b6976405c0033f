from .cmf import CMF

__all__ = ["CMF"]
