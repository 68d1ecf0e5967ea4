"""Synthetic MM-IMDB-, NTU- and EgoGesture-shaped data on disk (numpy, and
PIL for the Ego JPEGs; the port's own copy of
``bmnas_tpu/data/synthetic.make_mmimdb_synthetic``, ``make_ntu_synthetic``
and ``make_ego_synthetic``: the same seed writes the same files)."""
from __future__ import annotations

import json
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


def make_ego_synthetic(root: str, n_per_subset: int = 4, num_classes: int = 5,
                       hw: int = 48, frames: int = 12, seed: int = 0,
                       counts: dict = None, gestures_per_video: int = 1,
                       frame_wh: tuple = None, smooth: bool = False) -> str:
    """Write an EgoGesture-layout dataset (RGB and depth JPEG frame dirs and
    the annotation JSON that ``data.ego.make_dataset`` reads); returns the
    annotation's path.

    * ``counts``: samples a subset (training, validation, testing), in
      place of ``n_per_subset``;
    * ``gestures_per_video``: G annotated gestures of ``frames`` frames in
      one video dir of G * frames // 4 frames, their segments overlapping,
      as in the real corpus;
    * ``frame_wh``: the frames' (width, height), (hw, hw) by default;
    * ``smooth``: low-frequency gradient frames in place of noise (they
      compress about 10x better).
    """
    from PIL import Image

    rng = np.random.RandomState(seed)
    labels = [f"gesture{i}" for i in range(num_classes)]
    database = {}
    w, h = frame_wh if frame_wh else (hw, hw)
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]

    def frame_img(gray):
        if not smooth:
            shape = (h, w) if gray else (h, w, 3)
            return (rng.rand(*shape) * 255).astype(np.uint8)
        a, b, c = rng.rand(3) * 4 + 1
        base = ((np.sin(a * np.pi * xx + c) + np.cos(b * np.pi * yy)) * 0.25
                + 0.5)
        if gray:
            return (base * 255).astype(np.uint8)
        chans = [np.clip(base * s, 0, 1) for s in rng.rand(3) + 0.5]
        return (np.stack(chans, -1) * 255).astype(np.uint8)

    vid = 0
    for subset in ("training", "validation", "testing"):
        todo = counts.get(subset, n_per_subset) if counts else n_per_subset
        while todo > 0:
            g = min(gestures_per_video, todo)
            n_frames = frames if g == 1 else max(frames, g * frames // 4)
            subj = f"sub{vid:04d}"
            rgb_dir = os.path.join(root, subj, "scene1", "Color", "rgb1")
            depth_dir = os.path.join(root, subj, "scene1", "Depth", "depth1")
            os.makedirs(rgb_dir, exist_ok=True)
            os.makedirs(depth_dir, exist_ok=True)
            for f in range(1, n_frames + 1):
                Image.fromarray(frame_img(False)).save(
                    os.path.join(rgb_dir, f"{f:06d}.jpg"))
                # a 2-D uint8 array is an 'L' (8-bit gray) image
                Image.fromarray(frame_img(True)).save(
                    os.path.join(depth_dir, f"{f:06d}.jpg"))
            for k in range(g):
                start = (1 if n_frames == frames
                         else int(rng.randint(1, n_frames - frames + 2)))
                database[f"{subj}/scene1/Color/rgb1_{vid}_{k}"] = {
                    "subset": subset,
                    "annotations": {
                        "label": labels[rng.randint(num_classes)],
                        "start_frame": start,
                        "end_frame": start + frames - 1},
                }
            todo -= g
            vid += 1
    ann_path = os.path.join(root, "annotation.json")
    with open(ann_path, "w") as f:
        json.dump({"labels": labels, "database": database}, f)
    return ann_path


def _write_skeleton_file(path: str, num_frames: int, rng) -> None:
    """The NTU ``.skeleton`` text format that ``data.ntu.get_3d_skeleton``
    reads: two persons of 25 joints a frame."""
    lines = [str(num_frames)]
    for _ in range(num_frames):
        lines.append("2")                        # persons
        for _p in range(2):
            lines.append("0 0 0 0 0 0 0 0 0 2")  # body info line
            lines.append("25")                   # joint count line
            for _j in range(25):
                xyz = rng.randn(3) * 0.1
                lines.append(" ".join(f"{v:.4f}" for v in xyz)
                             + " 0 0 0 0 0 0 0 2")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def make_ntu_synthetic(root: str, n_videos_per_subject: int = 1,
                       subjects=(1, 2, 3, 8, 5, 6), num_actions: int = 6,
                       hw: int = 32, frames: int = 70, seed: int = 0,
                       ske_frames: int = None) -> str:
    """Write ``*_rgb.npy`` uint8 clips of ``frames`` x hw x hw and
    ``.skeleton`` files of ``ske_frames`` frames (default ``frames``), named
    S###C###P###R###A### so that the subject splits and labels apply.

    Past 900 clips a subject, the R field rolls over into higher camera
    numbers (C002, ...), as in the real corpus.
    """
    rng = np.random.RandomState(seed)
    ske_frames = frames if ske_frames is None else ske_frames
    rgb_dir = os.path.join(root, "nturgb+d_rgb_256x256_30")
    ske_dir = os.path.join(root, "nturgb+d_skeletons")
    os.makedirs(rgb_dir, exist_ok=True)
    os.makedirs(ske_dir, exist_ok=True)
    for subj in subjects:
        for r in range(n_videos_per_subject):
            action = rng.randint(1, num_actions + 1)
            name = (f"S001C{1 + r // 900:03d}P{subj:03d}"
                    f"R{(r % 900) + 1:03d}A{action:03d}")
            clip = rng.randint(0, 256, (frames, hw, hw, 3), dtype=np.uint8)
            np.save(os.path.join(rgb_dir, name + "_rgb.npy"), clip)
            _write_skeleton_file(os.path.join(ske_dir, name + ".skeleton"),
                                 ske_frames, rng)
    return root
