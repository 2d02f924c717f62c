"""Stand-alone improved precision and recall:
`python -m rick_tpu_torch.cli.precision_recall <real> <fake>`, the flags and
output line of `rick_tpu.cli.precision_recall` (the reference's
`gan_metrics/precision_recall.py` main; VGG16 fc2 manifolds, k 3).  Port of
`rick_tpu/cli/precision_recall.py`; runs on the card, TF32 off, VGG16 from
`default_vgg16_params()`.
"""

from __future__ import annotations

import argparse

from rick_tpu_torch.cli.fid import _load_images, no_tf32
from rick_tpu_torch.metrics import IPR


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser()
    p.add_argument("path_real", type=str)
    p.add_argument("path_fake", type=str)
    p.add_argument("--batch_size", type=int, default=50)
    p.add_argument("--k", type=int, default=3)
    p.add_argument("--num_samples", type=int, default=5000)
    p.add_argument("--size", type=int, default=256)
    args = p.parse_args(argv)
    no_tf32()

    ipr = IPR(args.batch_size, k=args.k, num_samples=args.num_samples, device=device)
    real = _load_images(args.path_real, args.size)[: args.num_samples]
    fake = _load_images(args.path_fake, args.size)[: args.num_samples]
    ipr.compute_manifold_ref(real)
    precision, recall = ipr.precision_and_recall(fake)
    print(f"precision: {precision:.4f} recall: {recall:.4f}")


if __name__ == "__main__":
    main()
