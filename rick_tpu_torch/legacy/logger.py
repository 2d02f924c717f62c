"""Stats logger with pickle persistence (`gan_training/logger.py:6-94`).
Port of `rick_tpu/legacy/logger.py`, over the port's `save_image_grid`."""

from __future__ import annotations

import os
import pickle
from collections import defaultdict

import torch

from rick_tpu_torch.utils.images import save_image_grid


class Logger:
    def __init__(self, log_dir: str = "./log", img_dir: str = "./imgs", monitoring=None, monitoring_dir=None):
        self.stats = defaultdict(lambda: defaultdict(list))
        self.log_dir = log_dir
        self.img_dir = img_dir
        os.makedirs(log_dir, exist_ok=True)
        os.makedirs(img_dir, exist_ok=True)

    def add(self, category: str, k: str, v, it: int):
        self.stats[category][k].append((it, float(v)))

    def add_imgs(self, imgs, class_name: str, it: int, nrow: int = 8):
        """imgs: (N, 3, H, W) in [-1, 1], a tensor or an array."""
        outdir = os.path.join(self.img_dir, class_name)
        os.makedirs(outdir, exist_ok=True)
        save_image_grid(torch.as_tensor(imgs), os.path.join(outdir, f"{it:08d}.png"), nrow=nrow)

    def get_last(self, category: str, k: str, default=0.0):
        if category in self.stats and k in self.stats[category] and self.stats[category][k]:
            return self.stats[category][k][-1][1]
        return default

    def save_stats(self, filename: str):
        with open(os.path.join(self.log_dir, filename), "wb") as f:
            pickle.dump({k: dict(v) for k, v in self.stats.items()}, f)

    def load_stats(self, filename: str):
        path = os.path.join(self.log_dir, filename)
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            loaded = pickle.load(f)
        for cat, d in loaded.items():
            for k, v in d.items():
                self.stats[cat][k] = v
