"""``matmul_dtype='bfloat16'`` on the card: the port's dense bf16 product
and packed bf16 gather expression (``skdist_tpu_torch.sparse``) against
the same expressions on the CPU. Dense: within twice the float32
summation-order bound of the exact products (cuBLAS sums in another
order, TF32 off); packed on dyadic data, whose rounded products and sums
are exact in float32: bitwise. Imports no jax (the card's machine has
none); the CPU checks against the JAX package are in
``tests/test_torch_bf16.py``.
"""

import numpy as np
import pytest
import torch

from skdist_tpu_torch import sparse as tsx
from skdist_tpu_torch.utils.device import exact_matmuls

U32 = 2.0 ** -24

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA device (runs on the card)"),
]


def _dyadic(rng, shape):
    """k / 16 with 0 < |k| < 256: exactly bf16."""
    return (rng.randint(1, 256, size=shape)
            * rng.choice([-1, 1], size=shape) / 16.0).astype(np.float32)


def test_dense_bf16_product_on_the_card_matches_the_cpu():
    rng = np.random.RandomState(5)
    X = torch.as_tensor(rng.randn(3000, 257).astype(np.float32))
    W = torch.as_tensor(rng.randn(258, 20).astype(np.float32))
    cpu = tsx.LinearOperator(X, True, matmul_dtype="bfloat16").matvec(W)
    with exact_matmuls():
        card = tsx.LinearOperator(X.cuda(), True,
                                  matmul_dtype="bfloat16").matvec(W.cuda())
    Xr = torch.cat([X, torch.ones(3000, 1)], 1).to(torch.bfloat16).double()
    absum = (Xr.abs() @ W.to(torch.bfloat16).double().abs()).float()
    bound = 258 * U32 * absum
    assert bool(((card.cpu() - cpu).abs() <= 2 * bound + 1e-30).all())


def test_packed_bf16_expression_on_the_card_matches_the_cpu():
    rng = np.random.RandomState(6)
    n, d, m = 2000, 4000, 41
    idx = torch.as_tensor(rng.randint(0, d, size=(n, m)).astype(np.int32))
    val = torch.as_tensor(_dyadic(rng, (n, m)))
    W = torch.as_tensor(_dyadic(rng, (d, 20)))
    cpu = tsx.packed_matvec_bf16(idx, val, W)
    card = tsx.packed_matvec_bf16(idx.cuda(), val.cuda(), W.cuda())
    torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=0)
