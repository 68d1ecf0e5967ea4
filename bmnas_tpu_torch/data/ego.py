"""EgoGesture dataset: JPEG frame sequences -> static-shape host batches.

Port of the evaluation path of ``bmnas_tpu/data/ego.py``
(temporal_center_crop, _resize, scale_center_crop, make_dataset,
_depth_dir, _load_jpg, EgoDataset):

* a JSON annotation (``labels``, ``database[key] = {subset, annotations
  {label, start_frame, end_frame}}``) gives the samples of a subset
  (``training``, ``validation``, ``testing``, or ``train_dev`` for the
  first two);
* a sample's RGB frames are ``<root>/<key before '_'>/%06d.jpg`` and its
  depth frames the same names under ``<two levels up>/Depth/depth<N>/``;
* the clip is the temporal centre crop of ``sample_duration`` frames (every
  ``downsample``-th), each frame scaled (short side to ``sample_size``,
  OpenCV's bilinear resize on uint8) and centre-cropped.

Batches carry ``rgb`` (B, T, S, S, 3) and ``depth`` (B, T, S, S, 1) uint8
(the model normalizes them on the device, ``models/ego.normalize_uint8_ego``),
an int32 ``label`` and a ``mask`` of valid rows; every batch has the full
batch size, the last one zero-padded. They are the JAX package's byte for
byte.

Decoding: OpenCV when it is installed, PIL otherwise, as in the JAX
package, with its two parity traps closed: colour frames are read with
``IMREAD_IGNORE_ORIENTATION`` (PIL, the reference's decoder, applies no
EXIF rotation), and a depth JPEG that is colour-encoded goes to PIL's
``convert('L')`` (OpenCV's luma differs from PIL's by one step). With
neither decoder a frame raises; nothing else is served.

The train transforms (the random temporal crop, the multi-scale random
crop) and the decode cache come with the Ego search (ROADMAP.md Queue 1
item 5b): ``train_transform=True`` is refused.
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Tuple

import numpy as np

EGO_MEAN = np.asarray([114.7748, 107.7354, 99.475], np.float32)
SAMPLE_SIZE = 112
SAMPLE_DURATION = 32
SMALL_SIZE = 64  # --small_dataset


def _cv2():
    """OpenCV, or None where it is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def temporal_center_crop(frame_indices: List[int], size: int,
                         downsample: int) -> List[int]:
    """The ``size * downsample`` frames around the centre, looped where the
    video is shorter, then every ``downsample``-th."""
    vid_duration = len(frame_indices)
    clip_duration = size * downsample
    center = len(frame_indices) // 2
    begin = max(0, center - clip_duration // 2)
    end = min(begin + clip_duration, vid_duration)
    out = list(frame_indices[begin:end])
    for index in list(out):
        if len(out) >= clip_duration:
            break
        out.append(index)
    while len(out) < clip_duration:
        out.extend(out[:clip_duration - len(out)])
    return [out[i] for i in range(0, clip_duration, downsample)]


def _resize(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """OpenCV's bilinear resize (``INTER_LINEAR``) to ``size_hw``; a
    one-channel frame keeps its channel axis."""
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError("the Ego frame path resizes with OpenCV "
                           "(cv2.INTER_LINEAR), which is not installed")
    out = cv2.resize(img, (size_hw[1], size_hw[0]),
                     interpolation=cv2.INTER_LINEAR)
    if out.ndim == 2:
        out = out[:, :, None]
    return out


def scale_center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Scale the short side to ``size`` (the long one to Python's
    ``round``), then crop the centre ``size`` x ``size``."""
    h, w = img.shape[:2]
    if w <= h:
        nw, nh = size, int(round(size * h / w))
    else:
        nh, nw = size, int(round(size * w / h))
    img = _resize(img, (nh, nw))
    y1 = (nh - size) // 2
    x1 = (nw - size) // 2
    return img[y1:y1 + size, x1:x1 + size]


def make_dataset(root_path: str, annotation_path: str, subset
                 ) -> Tuple[list, dict]:
    """The samples of ``subset`` (a name or a list of names) whose video
    directory exists, and the index -> label name map."""
    subsets = subset if isinstance(subset, list) else [subset]
    with open(annotation_path) as f:
        data = json.load(f)
    class_to_idx = {label: i for i, label in enumerate(data["labels"])}
    idx_to_class = {i: label for label, i in class_to_idx.items()}
    dataset = []
    for key, value in data["database"].items():
        if value["subset"] not in subsets:
            continue
        ann = value["annotations"]
        video_path = os.path.join(root_path, key.split("_")[0])
        if not os.path.exists(video_path):
            continue
        begin_t = int(float(ann["start_frame"]))
        end_t = int(float(ann["end_frame"]))
        dataset.append({
            "video": video_path,
            "frame_indices": list(range(begin_t, end_t + 1)),
            "label": class_to_idx[ann["label"]],
        })
    return dataset, idx_to_class


def _depth_dir(video_dir_path: str) -> str:
    """'<two levels up>/Depth/depth<last character of the RGB dir>'."""
    return os.path.join(video_dir_path.rsplit(os.sep, 2)[0], "Depth",
                        "depth" + video_dir_path[-1])


def _load_jpg(path: str, gray: bool) -> np.ndarray:
    """Decode a frame to uint8 (H, W, 3) RGB, or (H, W, 1) when ``gray``.

    OpenCV first: colour with ``IMREAD_IGNORE_ORIENTATION``; gray with
    ``IMREAD_UNCHANGED``, which keeps the encoded channel count, so that a
    colour-encoded gray JPEG is seen and sent to PIL's ``convert('L')``.
    PIL where OpenCV is not installed."""
    cv2 = _cv2()
    if cv2 is not None:
        if gray:
            arr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            if arr is not None and arr.ndim == 2:
                return arr[:, :, None]
            arr = None  # colour-encoded gray: PIL convert('L') for parity
        else:
            arr = cv2.imread(
                path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        if arr is not None:
            return cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"no JPEG decoder for {path}: "
            + ("a colour-encoded gray frame needs PIL's convert('L'), and "
               "PIL is not installed" if cv2 is not None else
               "neither OpenCV (cv2) nor PIL is installed")) from None
    with open(path, "rb") as f:
        with Image.open(f) as img:
            arr = np.asarray(img.convert("L" if gray else "RGB"), np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


class EgoDataset:
    """The RGB-D EgoGesture dataset, evaluation transforms."""

    def __init__(self, root_path: str, annotation_path: str, subset,
                 small_dataset: bool = False, sample_size: int = SAMPLE_SIZE,
                 sample_duration: int = SAMPLE_DURATION, downsample: int = 1,
                 train_transform: bool = False, num_workers: int = 8):
        if train_transform:
            raise NotImplementedError(
                "Ego train transforms: not ported yet (ROADMAP.md Queue 1 "
                "item 5b, the Ego search and found retraining)")
        if subset == "train_dev":
            subset = ["training", "validation"]
        self.data, self.class_names = make_dataset(root_path, annotation_path,
                                                   subset)
        if small_dataset:
            self.data = self.data[:SMALL_SIZE]
        self.sample_size = sample_size
        self.sample_duration = sample_duration
        self.downsample = downsample
        self._pool = ThreadPoolExecutor(max_workers=max(1, num_workers))

    def __len__(self):
        return len(self.data)

    def load_sample(self, idx: int) -> Dict[str, np.ndarray]:
        """One clip (the evaluation transforms draw nothing)."""
        rec = self.data[idx]
        indices = temporal_center_crop(rec["frame_indices"],
                                       self.sample_duration, self.downsample)
        depth_dir = _depth_dir(rec["video"])
        rgb_frames, depth_frames = [], []
        for i in indices:
            rgb = _load_jpg(os.path.join(rec["video"], f"{i:06d}.jpg"), False)
            dep = _load_jpg(os.path.join(depth_dir, f"{i:06d}.jpg"), True)
            rgb_frames.append(scale_center_crop(rgb, self.sample_size))
            depth_frames.append(scale_center_crop(dep, self.sample_size))
        return {"rgb": np.stack(rgb_frames),        # (T, S, S, 3) uint8
                "depth": np.stack(depth_frames),    # (T, S, S, 1) uint8
                "label": np.int32(rec["label"])}

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0,
                pad_to_full: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed % (2 ** 32)).shuffle(order)
        for start in range(0, len(self), batch_size):
            idxs = order[start:start + batch_size]
            samples = list(self._pool.map(self.load_sample, idxs))
            b = batch_size if pad_to_full else len(samples)
            out = {
                "rgb": np.zeros((b,) + samples[0]["rgb"].shape, np.uint8),
                "depth": np.zeros((b,) + samples[0]["depth"].shape,
                                  np.uint8),
                "label": np.zeros((b,), np.int32),
                "mask": np.zeros((b,), np.float32),
            }
            for i, s in enumerate(samples):
                out["rgb"][i] = s["rgb"]
                out["depth"][i] = s["depth"]
                out["label"][i] = s["label"]
                out["mask"][i] = 1.0
            yield out

    def num_batches(self, batch_size: int) -> int:
        return -(-len(self) // batch_size)
