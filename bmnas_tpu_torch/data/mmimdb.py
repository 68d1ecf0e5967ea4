"""MM-IMDB dataset: per-sample .npy triples -> static-shape host batches.

Port of ``bmnas_tpu/data/mmimdb.py`` (the threaded numpy path). Layout
``<root>/<stage>/{image,text,label}_{idx:06}.npy``; every batch has the
full batch size, the final one zero-padded, with a ``mask`` row-validity
vector; images are NHWC float32.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

SPLIT_SIZES = {"train": 15552, "dev": 2608, "test": 7799}
SMALL_SIZE = 64  # --small_dataset
NUM_CLASSES = 23
TEXT_DIM = 300


class MMIMDBDataset:
    def __init__(self, root_dir: str, stage: str, small_dataset: bool = False,
                 num_workers: int = 8, length: Optional[int] = None):
        if stage not in SPLIT_SIZES:
            raise ValueError(f"unknown MM-IMDB split {stage!r}")
        self.root_dir = root_dir
        self.stage = stage
        self.len_data = length if length is not None else (
            SMALL_SIZE if small_dataset else SPLIT_SIZES[stage])
        # clamp to the files actually present (synthetic/partial datasets)
        d = os.path.join(root_dir, stage)
        if os.path.isdir(d):
            available = len([f for f in os.listdir(d)
                             if f.startswith("label_")])
            if 0 < available < self.len_data:
                self.len_data = available
        self.num_workers = max(1, num_workers)

    def __len__(self) -> int:
        return self.len_data

    def _paths(self, idx: int):
        d = os.path.join(self.root_dir, self.stage)
        return (os.path.join(d, f"image_{idx:06}.npy"),
                os.path.join(d, f"text_{idx:06}.npy"),
                os.path.join(d, f"label_{idx:06}.npy"))

    def load_sample(self, idx: int) -> Dict[str, np.ndarray]:
        ip, tp, lp = self._paths(idx)
        image = np.load(ip).astype(np.float32)
        text = np.load(tp).astype(np.float32)
        label = np.load(lp).astype(np.float32)
        if (image.ndim == 3 and image.shape[0] in (1, 3)
                and image.shape[-1] not in (1, 3)):
            image = np.transpose(image, (1, 2, 0))  # CHW -> HWC
        # a (T, 300) word-vector sequence is mean-pooled, never truncated
        if text.ndim == 2 and text.shape[-1] == TEXT_DIM:
            text = text.mean(axis=0)
        else:
            text = text.reshape(-1)
            if text.shape[0] != TEXT_DIM:
                raise ValueError(
                    f"text_{idx:06}.npy has {text.shape[0]} features; "
                    f"expected {TEXT_DIM} (flat) or (T,{TEXT_DIM}) sequence")
        return {"image": image, "text": text, "label": label}

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0,
                pad_to_full: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Yield host batches with a 'mask' validity vector."""
        order = np.arange(self.len_data)
        if shuffle:
            np.random.RandomState(seed % (2**32)).shuffle(order)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for start in range(0, self.len_data, batch_size):
                idxs = order[start:start + batch_size]
                b = batch_size if pad_to_full else len(idxs)
                samples = list(pool.map(self.load_sample, idxs))
                out = {k: np.zeros((b,) + samples[0][k].shape, np.float32)
                       for k in ("image", "text", "label")}
                mask = np.zeros((b,), np.float32)
                for i, s in enumerate(samples):
                    for k in out:
                        out[k][i] = s[k]
                    mask[i] = 1.0
                out["mask"] = mask
                yield out

    def num_batches(self, batch_size: int) -> int:
        return -(-self.len_data // batch_size)
