"""Stateless counter-based random draws for the tree models and the SGD
shuffles.

The JAX package draws bootstrap counts, ``max_features`` uniforms and
ExtraTrees thresholds from ``jax.random`` keyed by each tree's seed, and
each SGD epoch's row order from ``jax.random.permutation``.
The port cannot reproduce that stream; it draws from a hash of
``(seed, level, purpose, index)`` instead, in torch integer ops, so that

- a round's T trees draw in one batched op (a ``torch.Generator`` gives
  one stream, not one per tree);
- the CPU and the card draw identical numbers (integer ops only, and
  the one float conversion is exact);
- OOB scoring regenerates each tree's bootstrap from its stored seed;
- an SGD epoch's row order is a function of ``(seed, epoch)`` alone
  (:func:`epoch_permutation`), so slicing a solve into resumable parts,
  or restarting a lane in another slot, cannot change it; a streamed
  epoch's block-local order is one of ``(seed, epoch, block)``
  (:func:`block_permutation`), so the feed cannot change it;
- a boosting fit's early-stopping validation rows are a function of its
  seed and row count alone (``models/gbdt.py validation_uniforms``).

The hash is the murmur3 32-bit finalizer chained over the key words.
Values are uint32 held in int64 tensors: torch has no unsigned 64-bit
type, and every product here is split so that it stays below 2**63
(no signed overflow).
"""

import torch

__all__ = [
    "BOOTSTRAP",
    "EXTRA_THRESHOLD",
    "FEATURE_SUBSET",
    "SHUFFLE",
    "VALIDATION",
    "bits32",
    "block_permutation",
    "bootstrap_counts",
    "epoch_permutation",
    "uniform",
]

#: purposes: distinct streams of one tree
BOOTSTRAP = 1
FEATURE_SUBSET = 2
EXTRA_THRESHOLD = 3
#: an SGD epoch's row order
SHUFFLE = 4
#: a boosting fit's early-stopping validation rows
VALIDATION = 5
#: the key of a streamed SGD epoch's block (its rows' order is then drawn
#: under SHUFFLE from that key)
BLOCK_SHUFFLE = 6

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x, c):
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a python
    int ``c`` in [0, 2**32), with no intermediate above 2**49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def bits32(seeds, level, purpose, index):
    """uint32 draws (as int64) for ``seeds (T,)`` and ``index`` (any
    shape, broadcast after the tree axis): returns ``(T, *index.shape)``.
    ``level`` and ``purpose`` are python ints."""
    seeds = torch.as_tensor(seeds).to(torch.int64) & _M32
    key = _fmix32(seeds ^ _mul32(torch.full_like(seeds, level + 1), _GOLDEN))
    key = _fmix32(key ^ purpose)
    index = torch.as_tensor(index, device=seeds.device).to(torch.int64) & _M32
    key = key.reshape((-1,) + (1,) * index.ndim)
    return _fmix32(_fmix32(_mul32(index, _GOLDEN)[None] ^ key) ^ (key >> 1))


def uniform(seeds, level, purpose, shape):
    """float32 uniforms in [0, 1) of shape ``(T, *shape)``: the top 24
    bits of :func:`bits32` over a row-major counter, times 2**-24
    (exact in float32)."""
    count = 1
    for s in shape:
        count *= int(s)
    device = torch.as_tensor(seeds).device
    index = torch.arange(count, device=device).reshape(tuple(shape))
    b = bits32(seeds, level, purpose, index)
    return (b >> 8).to(torch.float32) * (2.0 ** -24)


def bootstrap_counts(seeds, n, dtype=torch.float32):
    """Per-tree bootstrap counts ``(T, n)``: n draws with replacement
    from ``[0, n)``, as ``(bits * n) >> 32`` (``n < 2**31`` keeps the
    product below 2**63), counted per row. Integer-valued, so the same
    on every device."""
    seeds = torch.as_tensor(seeds)
    T = seeds.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"bootstrap over n={n} rows: at most 2**31-1")
    idx = (bits32(seeds, 0, BOOTSTRAP, torch.arange(n, device=seeds.device))
           * n) >> 32  # (T, n) in [0, n)
    flat = idx + torch.arange(T, device=seeds.device)[:, None] * n
    counts = torch.bincount(flat.reshape(-1), minlength=T * n)
    return counts.reshape(T, n).to(dtype)


def epoch_permutation(seed, epoch, padded, n, device=None):
    """The row order of SGD epoch ``epoch`` over ``padded`` slots (``n``
    rows padded up to whole batches): the stable argsort of
    :func:`bits32` over the slot counter, each slot then mapped to row
    ``slot % n``, so the padding wraps around as in the JAX package.
    Integer ops and a stable sort, so the CPU and the card give the same
    order. Returns an int64 tensor of shape ``(padded,)``."""
    keys = bits32(torch.tensor([int(seed)], device=device), int(epoch),
                  SHUFFLE, torch.arange(padded, device=device))[0]
    return torch.argsort(keys, stable=True) % n


def block_permutation(seed, epoch, block, rows, device=None):
    """The order of the ``rows`` rows of block ``block`` in streamed SGD
    epoch ``epoch``: the stable argsort of :func:`bits32` over the row
    counter, keyed by a draw of ``(seed, epoch, block)``. Integer ops and a
    stable sort, as :func:`epoch_permutation`. Returns an int64 tensor of
    shape ``(rows,)``, a permutation of ``range(rows)``."""
    key = bits32(torch.tensor([int(seed)], device=device), int(epoch),
                 BLOCK_SHUFFLE, torch.tensor([int(block)], device=device))
    keys = bits32(key[:, 0], 0, SHUFFLE, torch.arange(rows, device=device))[0]
    return torch.argsort(keys, stable=True)
