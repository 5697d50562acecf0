"""Estimators of the port."""

from .forest import (
    ExtraTreesClassifier,
    ExtraTreesRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
    RandomTreesEmbedding,
)
from .gbdt import (
    DistHistGradientBoostingClassifier,
    DistHistGradientBoostingRegressor,
)
from .linear import (
    LinearRegression,
    LinearSVC,
    LogisticRegression,
    Ridge,
    RidgeClassifier,
    SGDClassifier,
)
from .naive_bayes import GaussianNB, MultinomialNB
from .tree import (
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    ExtraTreeClassifier,
    ExtraTreeRegressor,
)

__all__ = [
    "DecisionTreeClassifier",
    "DecisionTreeRegressor",
    "DistHistGradientBoostingClassifier",
    "DistHistGradientBoostingRegressor",
    "ExtraTreeClassifier",
    "ExtraTreeRegressor",
    "ExtraTreesClassifier",
    "ExtraTreesRegressor",
    "GaussianNB",
    "LinearRegression",
    "LinearSVC",
    "LogisticRegression",
    "MultinomialNB",
    "RandomForestClassifier",
    "RandomForestRegressor",
    "RandomTreesEmbedding",
    "Ridge",
    "RidgeClassifier",
    "SGDClassifier",
]
