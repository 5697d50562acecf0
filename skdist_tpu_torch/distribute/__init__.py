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
from .adaptive import HalvingSpec, RungKilledWarning
from .multiclass import DistOneVsOneClassifier, DistOneVsRestClassifier
from .predict import batch_predict, device_predict_plan, get_prediction_udf
from .search import DistGridSearchCV, DistRandomizedSearchCV

__all__ = [
    "DistExtraTreesClassifier",
    "DistExtraTreesRegressor",
    "DistGridSearchCV",
    "DistOneVsOneClassifier",
    "DistOneVsRestClassifier",
    "DistRandomForestClassifier",
    "DistRandomForestRegressor",
    "DistRandomTreesEmbedding",
    "DistRandomizedSearchCV",
    "HalvingSpec",
    "RungKilledWarning",
    "batch_predict",
    "device_predict_plan",
    "get_oof",
    "get_prediction_udf",
    "get_single_oof",
]
