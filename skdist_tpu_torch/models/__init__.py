"""Estimators of the port."""

from .forest import (
    ExtraTreesClassifier,
    ExtraTreesRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
    RandomTreesEmbedding,
)
from .linear import (
    LinearRegression,
    LinearSVC,
    LogisticRegression,
    Ridge,
    RidgeClassifier,
    SGDClassifier,
)
from .tree import (
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    ExtraTreeClassifier,
    ExtraTreeRegressor,
)

__all__ = [
    "DecisionTreeClassifier",
    "DecisionTreeRegressor",
    "ExtraTreeClassifier",
    "ExtraTreeRegressor",
    "ExtraTreesClassifier",
    "ExtraTreesRegressor",
    "LinearRegression",
    "LinearSVC",
    "LogisticRegression",
    "RandomForestClassifier",
    "RandomForestRegressor",
    "RandomTreesEmbedding",
    "Ridge",
    "RidgeClassifier",
    "SGDClassifier",
]
