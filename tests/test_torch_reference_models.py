"""The JAX-fitted models of ``build_tools/torch_reference_models.npz``
(written by ``build_tools/make_torch_reference_models.py``), converted
into the port on the CPU as ``chip_smoke.py`` phase 21e converts them on
the card: the port's decisions and probabilities against the JAX
package's stored ones, with phase 21e's tolerances (the GBDT's
decisions within 1e-6 of the largest, GaussianNB's within 1e-5;
probabilities within that share of the largest decision).
"""

import numpy as np
import pytest

import chip_smoke
from skdist_tpu_torch import convert


@pytest.mark.parametrize("name", ["gbdt", "gnb"])
def test_reference_models_convert_on_the_cpu(name):
    rows, refs = chip_smoke.reference_models()
    ref, proba, dec = refs[name]
    to_port = (convert.gbdt_from_reference if name == "gbdt"
               else convert.naive_bayes_from_reference)
    model = to_port(ref, device="cpu")
    tol = 1e-6 if name == "gbdt" else 1e-5
    scale = float(np.abs(dec).max())
    z = model.decision_function(rows)
    assert float(np.abs(z - dec).max()) <= tol * scale
    np.testing.assert_allclose(model.predict_proba(rows), proba, rtol=0,
                               atol=tol * max(1.0, scale))
    assert list(model.classes_) == [0, 1]
