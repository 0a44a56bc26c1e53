"""Whole-image parity bounds, in numpy.

The bounds of the reference's image parity gate (`bench.py`
`parity_gate`): two renders of one scene pass when the 1%-trimmed
correlation exceeds 0.998, the full correlation 0.98, the mean
relative difference stays under 5%, and the trimmed-off outlier pixels
do not cluster (at most max(8, n/4) of them in any 8x8 tile).  Tie-level
hit flips between two float pipelines scatter over the frame; a
systematic fault concentrates in a region or shifts the mean.

One addition: a trimmed-off value that agrees to `NOISE_RTOL` is not an
outlier.  When two renders agree to float rounding (a CUDA image
against the CPU image of the same port), the largest 1% of differences
are rounding noise, which grows with brightness and so gathers in the
brightest tile; only differences above that noise can show a fault.
"""

from __future__ import annotations

import numpy as np

NOISE_RTOL = 1e-5


def image_parity(img_a: np.ndarray, img_b: np.ndarray) -> dict:
    """Statistics of two [H, W, 3] images and whether they pass."""
    h, w, _ = img_a.shape
    a = np.asarray(img_a, np.float64).ravel()
    b = np.asarray(img_b, np.float64).ravel()
    corr = float(np.corrcoef(a, b)[0, 1])
    d = np.abs(a - b)
    order = np.argsort(d)
    n_keep = int(len(d) * 0.99)
    keep = order[:n_keep]
    corr_trim = float(np.corrcoef(a[keep], b[keep])[0, 1])
    rel = float(d.mean() / max(b.mean(), 1e-9))
    out = order[n_keep:]
    out = out[d[out] > NOISE_RTOL * np.maximum(np.abs(a[out]),
                                               np.abs(b[out]))]
    pix = np.unique(out // 3)
    tiles = (pix // w // 8) * ((w + 7) // 8) + (pix % w) // 8
    max_tile = int(np.bincount(tiles).max()) if len(tiles) else 0
    tile_cap = max(8, len(pix) // 4)
    ok = (corr_trim > 0.998 and corr > 0.98 and rel < 0.05
          and max_tile <= tile_cap)
    return {"ok": bool(ok), "corr": corr, "corr_trim": corr_trim,
            "mean_rel_diff": rel, "max_abs_diff": float(d.max()),
            "outlier_pixels": int(len(pix)),
            "max_outliers_per_tile": max_tile, "tile_cap": tile_cap}
