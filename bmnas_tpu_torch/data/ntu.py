"""NTU RGB+D dataset: video + skeleton -> static-shape host batches.

Port of the streaming path of ``bmnas_tpu/data/ntu.py`` (SUBJECTS,
load_video, get_3d_skeleton, _linear_interp_T, aug_crop_select, aug_crop,
center_crop, normalize_len, normalize_sample, NTUDataset). Subject-ID
splits are read from filename characters [9:12] and the label from [17:20]
- 1. Batches carry the clip ``image`` (B, vid_len[0], H, W, 3), uint8 for
uint8 sources (the model normalizes it on the device), the ``skeleton``
(B, vid_len[1], 25, 2, 3) fp32 channels-last centred on joint 2 of person
0, an int32 ``label`` and a ``mask`` of valid rows; every batch has the
full batch size, the last one zero-padded.

With ``train_transform`` every sample gets the random temporal crop
(``aug_crop``) from its own seed, ``seed * 7919 + idx`` of the epoch's
seed, so the train batches are the JAX package's byte for byte.

Skeletons go through the Python parser only (a native parser, the frame
pool and ``hybrid_batches`` come with the port's data-path work, ROADMAP.md
Queue 1 item 6).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Tuple

import numpy as np

SUBJECTS = {
    "train": [1, 4, 8, 13, 15, 16, 17, 18, 19, 25, 27, 28, 31, 34, 35, 38],
    "train_val": [1, 2, 4, 5, 8, 9, 13, 14, 15, 16, 17, 18, 19, 25, 27, 28,
                  31, 34, 35, 38],
    "train_exp": [1, 8, 15, 17, 19, 27, 31, 35],
    "test": [3, 6, 7, 10, 11, 12, 20, 21, 22, 23, 24, 26, 29, 30, 32, 33, 36,
             37, 39, 40],
    "dev": [2, 5, 9, 14],
}
SMALL_SIZE = 64  # --small_dataset

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def load_video(path: str, vid_len: int = 24) -> np.ndarray:
    """A clip as (frames, H, W, 3). ``.npy`` clips load as they are (uint8
    stays uint8, anything else becomes fp32). Videos are decoded with
    OpenCV (BGR uint8) and sampled at ``linspace(0, N, vid_len)``: index N
    never lands (its slot stays zero) and duplicate indices of a short
    video collapse to one slot each."""
    if path.endswith(".npy"):
        arr = np.load(path)
        return arr if arr.dtype == np.uint8 else arr.astype(np.float32)
    import cv2
    cap = cv2.VideoCapture(path)
    try:
        num_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        video = np.zeros((vid_len, height, width, 3), np.uint8)
        taken = np.unique(np.linspace(0, num_frames, vid_len).astype(int))
        taken = taken[taken < num_frames]
        slot = 0
        for fr_idx in range(int(taken[-1]) + 1 if len(taken) else 0):
            if not cap.grab():
                break
            if fr_idx == taken[slot]:
                ret, frame = cap.retrieve()
                if not ret:
                    break
                video[slot] = frame
                slot += 1
    finally:
        cap.release()
    return video


def get_3d_skeleton(path: str) -> np.ndarray:
    """The NTU text skeleton format -> (3, T, 25, 2), NaNs as zeros."""
    with open(path) as f:
        content = [c.strip() for c in f.readlines()]
    num_frames = int(content[0])
    xyz = np.zeros((3, num_frames, 25, 2), np.float32)
    i = 1
    for t in range(num_frames):
        nb_person = int(content[i])
        for p in range(nb_person):
            i += 2
            for j in range(25):
                i += 1
                vals = [float(c) for c in content[i].split(" ")]
                if p < 2:
                    xyz[:, t, j, p] = vals[:3]
        i += 1
    return np.nan_to_num(xyz)


def _linear_interp_T(data: np.ndarray, out_len: int) -> np.ndarray:
    """Linear resize of (C, T, V, M) along T with half-pixel centres
    (align_corners=False) -> (C, out_len, V, M)."""
    T = data.shape[1]
    src = (np.arange(out_len) + 0.5) * T / out_len - 0.5
    src = np.clip(src, 0, T - 1)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, T - 1)
    w = (src - lo).astype(np.float32)
    return (data[:, lo] * (1 - w)[None, :, None, None]
            + data[:, hi] * w[None, :, None, None])


def aug_crop_select(n_rgb: int, ske: np.ndarray, rng: np.random.RandomState,
                    p_interval: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """The random temporal crop, its video half as frame indices: returns
    the indices of the ``n_rgb`` clip frames the crop keeps, and the
    cropped skeleton ``(3, T', V, M)``.

    The rng draws in the JAX package's order: the video ratio first, then
    the skeleton's share ``p``, then its start ``bias``. The skeleton keeps
    ``min(max(floor(T * p), 64), T)`` frames."""
    ratio = 1.0 - p_interval * rng.rand()
    if n_rgb > 0:
        begin = (n_rgb - int(n_rgb * ratio)) // 2
        rgb_idx = np.arange(begin, n_rgb - begin)
    else:
        rgb_idx = np.arange(0)
    if ske.ndim > 1:
        valid = ske.shape[1]
        p = float(rng.rand(1)[0]) * (1.0 - p_interval) + p_interval
        cropped = int(np.minimum(np.maximum(int(np.floor(valid * p)), 64),
                                 valid))
        bias = rng.randint(0, valid - cropped + 1)
        ske = ske[:, bias:bias + cropped]
    return rgb_idx, ske


def aug_crop(rgb: np.ndarray, ske: np.ndarray, rng: np.random.RandomState,
             p_interval: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """Random temporal crop of a clip and its skeleton
    (``aug_crop_select`` applied to the clip)."""
    n_rgb = len(rgb) if rgb.ndim > 1 else 0
    rgb_idx, ske = aug_crop_select(n_rgb, ske, rng, p_interval)
    if rgb.ndim > 1:
        rgb = rgb[rgb_idx]
    return rgb, ske


def center_crop(rgb: np.ndarray, ske: np.ndarray,
                p_interval: float = 0.9) -> Tuple[np.ndarray, np.ndarray]:
    """Keep the middle ``p_interval`` of the skeleton and clip frames."""
    if ske.ndim > 1:
        valid = ske.shape[1]
        bias = int((1 - p_interval) * valid / 2)
        ske = ske[:, bias:valid - bias]
    if rgb.ndim > 1:
        n = len(rgb)
        bias = int((1 - p_interval) * n / 2)
        rgb = rgb[bias:n - bias]
    return rgb, ske


def normalize_len(rgb: np.ndarray, ske: np.ndarray,
                  vid_len: Tuple[int, int] = (8, 32)):
    """Uniform resample to (vid_len[0] clip frames, vid_len[1] skeleton
    frames)."""
    if rgb.ndim > 1:
        idx = np.linspace(0, len(rgb) - 1, vid_len[0]).astype(int)
        rgb = rgb[idx]
    if ske.ndim > 1:
        ske = _linear_interp_T(ske, vid_len[1])
    return rgb, ske


def _normalize_image(rgb: np.ndarray) -> np.ndarray:
    """/255 and ImageNet statistics, fp32."""
    rgb = rgb / 255.0
    return ((rgb - IMAGENET_MEAN.reshape(1, 1, 1, 3))
            / IMAGENET_STD.reshape(1, 1, 1, 3)).astype(np.float32)


def normalize_sample(rgb: np.ndarray, ske: np.ndarray,
                     image_on_host: bool = True):
    """Clip /255 and ImageNet statistics; skeleton centred on joint 2 of
    person 0. ``image_on_host=False`` keeps uint8 pixels as they are, for
    the model to normalize on the device (a quarter of the bytes to
    upload); the later temporal steps only select frames, so the order
    does not matter."""
    if image_on_host or rgb.dtype != np.uint8:
        rgb = _normalize_image(rgb)
    origin = ske[:, :, 1, 0]
    ske = ske - origin[:, :, None, None]
    return rgb, ske.astype(np.float32)


class NTUDataset:
    """File-list dataset over the NTU layout
    (``nturgb+d_rgb_{dim}x{dim}_{fr}/*_rgb.{avi,npy}`` and
    ``nturgb+d_skeletons/*.skeleton``); ``train_transform`` adds the random
    temporal crop before the resample."""

    def __init__(self, root_dir: str, stage: str, small_dataset: bool = False,
                 vid_len: Tuple[int, int] = (8, 32), vid_dim: int = 256,
                 vid_fr: int = 30, num_workers: int = 8,
                 train_transform: bool = False):
        subjects = SUBJECTS[stage]
        self.train_transform = train_transform
        basename_rgb = os.path.join(
            root_dir, "nturgb+d_rgb_{0}x{0}_{1}".format(vid_dim, vid_fr))
        basename_ske = os.path.join(root_dir, "nturgb+d_skeletons")
        self.vid_len = tuple(vid_len)
        self.num_workers = max(1, num_workers)

        def ours(f):
            return int(f[9:12]) in subjects
        rgb_files = [f for f in sorted(os.listdir(basename_rgb))
                     if (f.endswith("_rgb.avi") or f.endswith("_rgb.npy"))
                     and ours(f)]
        self.rgb_list = [os.path.join(basename_rgb, f) for f in rgb_files]
        self.ske_list = [os.path.join(basename_ske, f)
                         for f in sorted(os.listdir(basename_ske))
                         if f.split(".")[-1] == "skeleton" and ours(f)]
        self.labels = [int(f[17:20]) for f in rgb_files]
        # two independent directory scans: a file missing on one side would
        # pair one sample's video with another's skeleton
        if len(self.rgb_list) != len(self.ske_list):
            raise ValueError(
                f"NTU rgb/skeleton list length mismatch for stage {stage!r}: "
                f"{len(self.rgb_list)} videos vs {len(self.ske_list)} "
                "skeletons")
        for rp, sp in zip(self.rgb_list, self.ske_list):
            rb, sb = os.path.basename(rp), os.path.basename(sp)
            if rb[:20] != sb[:20]:
                raise ValueError(
                    f"NTU rgb/skeleton filename misalignment: {rb} vs {sb}")
        if small_dataset:
            self.rgb_list = self.rgb_list[:SMALL_SIZE]
            self.ske_list = self.ske_list[:SMALL_SIZE]
            self.labels = self.labels[:SMALL_SIZE]

    def __len__(self) -> int:
        return len(self.labels)

    def load_sample(self, idx: int, seed: int) -> Dict[str, np.ndarray]:
        """One sample; ``seed`` drives its random crop (train transform)."""
        rng = np.random.RandomState(seed % (2**32))
        rgb = load_video(self.rgb_list[idx])
        ske = get_3d_skeleton(self.ske_list[idx])
        rgb, ske = normalize_sample(rgb, ske, image_on_host=False)
        if self.train_transform:
            rgb, ske = aug_crop(rgb, ske, rng)
        rgb, ske = normalize_len(rgb, ske, self.vid_len)
        # channels-last skeleton: (3, T, V, M) -> (T, V, M, 3)
        return {"image": rgb, "skeleton": np.transpose(ske, (1, 2, 3, 0)),
                "label": np.int32(self.labels[idx] - 1)}

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0,
                pad_to_full: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Host batches with a ``mask`` validity vector. Sample ``i`` is
        loaded with the seed ``seed * 7919 + i``."""
        seed = seed % (2**32)
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for start in range(0, len(self), batch_size):
                idxs = order[start:start + batch_size]
                samples = list(pool.map(self.load_sample, idxs,
                                        [int(seed * 7919 + i)
                                         for i in idxs]))
                # a split that mixes uint8 and float clips: one batch has
                # one dtype, so the uint8 ones are normalized here, by the
                # same arithmetic as the device
                if len({s["image"].dtype for s in samples}) > 1:
                    for s in samples:
                        if s["image"].dtype == np.uint8:
                            s["image"] = _normalize_image(s["image"])
                b = batch_size if pad_to_full else len(samples)
                out = {
                    "image": np.zeros((b,) + samples[0]["image"].shape,
                                      samples[0]["image"].dtype),
                    "skeleton": np.zeros((b,) + samples[0]["skeleton"].shape,
                                         np.float32),
                    "label": np.zeros((b,), np.int32),
                    "mask": np.zeros((b,), np.float32),
                }
                for i, s in enumerate(samples):
                    out["image"][i] = s["image"]
                    out["skeleton"][i] = s["skeleton"]
                    out["label"][i] = s["label"]
                    out["mask"][i] = 1.0
                yield out

    def num_batches(self, batch_size: int) -> int:
        return -(-len(self) // batch_size)
