"""Write ``build_tools/torch_reference_models.npz``: a
``DistHistGradientBoostingClassifier`` and a ``GaussianNB`` fitted by the
JAX package on the CPU, as plain arrays, with the JAX package's own
``predict_proba`` and ``decision_function`` of the first ``N_CHECK``
rows.

``chip_smoke.py`` (phase 21e) rebuilds the rows from the same numpy seed
(``chip_smoke.balanced_tabular``), converts both models into the port
with ``skdist_tpu_torch.convert`` and holds the card's probabilities to
the stored ones; the card's machine has no JAX. ``tests/
test_torch_reference_models.py`` holds the port's CPU conversion to the
same file. Run from the repository root:

    python build_tools/make_torch_reference_models.py
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import balanced_tabular  # noqa: E402
from skdist_tpu.models import GaussianNB  # noqa: E402
from skdist_tpu.models.gbdt import (  # noqa: E402
    DistHistGradientBoostingClassifier,
)

OUT = os.path.join(ROOT, "build_tools", "torch_reference_models.npz")
#: rows of the fit, the seed of ``balanced_tabular``, rows checked
N_FIT, SEED, N_CHECK = 20_000, 7, 2_000
GBDT_PARAMS = dict(max_iter=20, max_depth=5, max_bins=64,
                   early_stopping=False, hist_mode="scatter")


def main():
    X, y = balanced_tabular(N_FIT, seed=SEED)
    gbdt = DistHistGradientBoostingClassifier(**GBDT_PARAMS).fit(X, y)
    gnb = GaussianNB().fit(X, y)
    out = {"n_fit": N_FIT, "seed": SEED, "n_check": N_CHECK}
    for name, est in (("gbdt", gbdt), ("gnb", gnb)):
        for k, v in est._params.items():
            out[f"{name}.params.{k}"] = np.asarray(v)
        out[f"{name}.meta"] = json.dumps({
            "n_features": int(est._meta["n_features"]),
            "n_samples": int(est._meta.get("n_samples", N_FIT)),
            "classes": np.asarray(est._meta["classes"]).tolist()})
        out[f"{name}.get_params"] = json.dumps(est.get_params(deep=False))
        out[f"{name}.proba"] = np.asarray(est.predict_proba(X[:N_CHECK]),
                                          np.float32)
        out[f"{name}.decision"] = np.asarray(
            est.decision_function(X[:N_CHECK]), np.float32)
    np.savez_compressed(OUT, **out)
    print(f"wrote {os.path.relpath(OUT, ROOT)}: GBDT n_iter_ {gbdt.n_iter_},"
          f" {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
