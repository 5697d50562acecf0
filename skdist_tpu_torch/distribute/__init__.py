"""Distributed meta-estimators of the port."""

from .search import DistGridSearchCV

__all__ = ["DistGridSearchCV"]
