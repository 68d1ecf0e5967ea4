"""Synthetic MM-IMDB-shaped data on disk (numpy; the port's own copy of
``bmnas_tpu/data/synthetic.make_mmimdb_synthetic``: the same seed writes
the same files)."""
from __future__ import annotations

import os

import numpy as np

from bmnas_tpu_torch.data.mmimdb import NUM_CLASSES, TEXT_DIM


def make_mmimdb_synthetic(root: str, n_per_stage: int = 8,
                          image_hw=(32, 32), seed: int = 0,
                          correlated: bool = False,
                          counts: dict = None) -> str:
    """Write train/dev/test splits in the MM-IMDB npy layout.

    ``correlated=True`` makes label k a function of text block k's mean (a
    learnable rule). ``counts`` overrides the per-stage sample count.
    """
    rng = np.random.RandomState(seed)
    block = TEXT_DIM // NUM_CLASSES
    for stage in ("train", "dev", "test"):
        d = os.path.join(root, stage)
        os.makedirs(d, exist_ok=True)
        n_stage = counts.get(stage, n_per_stage) if counts else n_per_stage
        for i in range(n_stage):
            img = rng.randn(*image_hw, 3).astype(np.float32)
            txt = rng.randn(TEXT_DIM).astype(np.float32)
            if correlated:
                lab = (txt[:block * NUM_CLASSES].reshape(NUM_CLASSES, block)
                       .mean(axis=1) > 0).astype(np.float32)
            else:
                lab = (rng.rand(NUM_CLASSES) < 0.2).astype(np.float32)
            np.save(os.path.join(d, f"image_{i:06}.npy"), img)
            np.save(os.path.join(d, f"text_{i:06}.npy"), txt)
            np.save(os.path.join(d, f"label_{i:06}.npy"), lab)
    return root
