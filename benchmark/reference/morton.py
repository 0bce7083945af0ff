"""Morton (Z-order) pixel permutations.

Raster-order ray tiles are full-width strips whose bounding cones are wide
(~23° at 512 rays of a 128px image) — useless for culling. Morton order
makes every contiguous run of 4^k rays a compact 2^k × 2^k pixel block
(~4° cones), so tile culling (ops/culling.py) actually culls. Applies to
both rendering (permute rays, inverse-permute the image) and the training
dataset (store rays Morton-ordered per view; sorted batch indices then
yield coherent tiles).
"""

from __future__ import annotations

import numpy as np


def morton2(x: np.ndarray, y: np.ndarray, bits: int = 16) -> np.ndarray:
    """Interleave x/y bits → Z-order code (uint64)."""
    code = np.zeros(np.broadcast(x, y).shape, dtype=np.uint64)
    x = x.astype(np.uint64)
    y = y.astype(np.uint64)
    for b in range(bits):
        code |= ((x >> np.uint64(b)) & np.uint64(1)) << np.uint64(2 * b)
        code |= ((y >> np.uint64(b)) & np.uint64(1)) << np.uint64(2 * b + 1)
    return code


def morton_permutation(width: int, height: int) -> np.ndarray:
    """perm such that raster_array[perm] is Morton-ordered.

    Inverse (back to raster order): inv = np.argsort(perm).
    """
    yy, xx = np.mgrid[0:height, 0:width]
    return np.argsort(morton2(xx.ravel(), yy.ravel()), kind="stable")


def multi_view_morton_permutation(width: int, height: int,
                                  views: int) -> np.ndarray:
    """View-major Morton permutation over a concatenated multi-view dataset."""
    base = morton_permutation(width, height)
    n = width * height
    return np.concatenate([base + v * n for v in range(views)])
