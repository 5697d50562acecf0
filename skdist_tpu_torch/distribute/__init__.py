"""Distributed meta-estimators of the port."""

from .ensemble import (
    DistExtraTreesClassifier,
    DistExtraTreesRegressor,
    DistForestClassifier,
    DistForestRegressor,
    DistRandomForestClassifier,
    DistRandomForestRegressor,
    DistRandomTreesEmbedding,
    get_oof,
    get_single_oof,
)
from .adaptive import HalvingSpec, RungKilledWarning
from .eliminate import DistFeatureEliminator
from .multiclass import DistOneVsOneClassifier, DistOneVsRestClassifier
from .predict import batch_predict, device_predict_plan, get_prediction_udf
from .search import (
    DistGridSearchCV,
    DistMultiModelSearch,
    DistRandomizedSearchCV,
)

__all__ = [
    "DistExtraTreesClassifier",
    "DistExtraTreesRegressor",
    "DistFeatureEliminator",
    "DistForestClassifier",
    "DistForestRegressor",
    "DistGridSearchCV",
    "DistMultiModelSearch",
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
