"""NTU RGB+D preprocessing: rescale the raw videos to 256x256 at 30 fps.

Port of ``bmnas_tpu/data/prepare_ntu.py``, with OpenCV (imported inside
the functions) in place of an ffmpeg binary. It writes the layout that
``data/ntu.NTUDataset`` reads, ``<out>/nturgb+d_rgb_<dim>x<dim>_<fps>/
<name>_rgb.avi``, and ``<out>/video_lengths.pkl`` (video id -> frame
count):

    python -m bmnas_tpu_torch.data.prepare_ntu --raw <dir of *_rgb.avi> \\
        --out <dataset root> [--dim 256] [--fps 30] [--j 8]
"""
from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Optional


def rescale_video(src: str, dst: str, dim: int = 256, fps: int = 30) -> int:
    """Rescale one video (INTER_AREA, MJPG); returns its frame count."""
    import cv2
    cap = cv2.VideoCapture(src)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    out = cv2.VideoWriter(dst, cv2.VideoWriter_fourcc(*"MJPG"), fps,
                          (dim, dim))
    try:
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            out.write(cv2.resize(frame, (dim, dim),
                                 interpolation=cv2.INTER_AREA))
    finally:
        cap.release()
        out.release()
    return n


def prepare(raw_rgb_dir: str, out_dir: str, dim: int = 256, fps: int = 30,
            num_workers: int = 8, limit: Optional[int] = None) -> str:
    """Rescale every ``*_rgb.avi`` under ``raw_rgb_dir`` (the first
    ``limit`` in name order, if given) and write the id -> length pickle;
    returns the video directory."""
    dst_dir = os.path.join(out_dir, f"nturgb+d_rgb_{dim}x{dim}_{fps}")
    os.makedirs(dst_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(raw_rgb_dir)
                   if f.endswith("_rgb.avi"))
    if limit:
        files = files[:limit]

    def work(f):
        n = rescale_video(os.path.join(raw_rgb_dir, f),
                          os.path.join(dst_dir, f), dim, fps)
        return f[:-len("_rgb.avi")], n

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        lengths = dict(pool.map(work, files))
    with open(os.path.join(out_dir, "video_lengths.pkl"), "wb") as fh:
        pickle.dump(lengths, fh)
    return dst_dir


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description="NTU video preprocessing")
    p.add_argument("--raw", required=True, help="dir of raw *_rgb.avi files")
    p.add_argument("--out", required=True, help="output dataset root")
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--j", type=int, default=8)
    a = p.parse_args()
    print(prepare(a.raw, a.out, a.dim, a.fps, a.j))
