"""Distributed meta-estimators of the port."""

from .ensemble import (
    DistExtraTreesClassifier,
    DistExtraTreesRegressor,
    DistRandomForestClassifier,
    DistRandomForestRegressor,
    DistRandomTreesEmbedding,
    get_oof,
    get_single_oof,
)
from .search import DistGridSearchCV

__all__ = [
    "DistExtraTreesClassifier",
    "DistExtraTreesRegressor",
    "DistGridSearchCV",
    "DistRandomForestClassifier",
    "DistRandomForestRegressor",
    "DistRandomTreesEmbedding",
    "get_oof",
    "get_single_oof",
]
