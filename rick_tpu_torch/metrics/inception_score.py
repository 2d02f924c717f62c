"""The KL-based Inception Score (`gan_training/metrics/inception_score.py:12-58`):
softmax of InceptionV3's logits, per split exp(mean KL(p(y|x) || p(y))),
mean and std over the splits.  Port of `rick_tpu/metrics/inception_score.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from rick_tpu_torch.metrics.inception import InceptionV3


def inception_score(imgs, model: InceptionV3, *, batch_size: int = 32, splits: int = 1, resize: bool = False):
    """(mean, std) of the score of `imgs` ((N, 3, H, W) in the generator's
    range, numpy or a tensor) by `model`, in batches of `batch_size` < N."""
    n = imgs.shape[0]
    if not 0 < batch_size < n:
        raise ValueError(f"batch_size {batch_size} must be in (0, {n})")
    device = model.fc.weight.device
    preds = np.zeros((n, 1000))
    with torch.inference_mode():
        for s in range(0, n, batch_size):
            batch = torch.as_tensor(imgs[s : s + batch_size]).to(device=device, dtype=torch.float32)
            logits = model.logits(batch, resize_input=resize)
            preds[s : s + batch.shape[0]] = torch.softmax(logits, dim=-1).cpu().numpy()

    split_scores = []
    for k in range(splits):
        part = preds[k * (n // splits) : (k + 1) * (n // splits)]
        py = np.mean(part, axis=0)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12)[None])
        split_scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(split_scores)), float(np.std(split_scores))
