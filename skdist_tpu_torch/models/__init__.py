"""Estimators of the port."""

from .linear import LogisticRegression

__all__ = ["LogisticRegression"]
