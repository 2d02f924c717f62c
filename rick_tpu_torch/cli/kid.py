"""Stand-alone KID: `python -m rick_tpu_torch.cli.kid <path> <path>`, the
flags and output line of `rick_tpu.cli.kid` (the reference's
`gan_metrics/kid_score.py` main): the polynomial-kernel MMD^2 over
`--n_subsets` subsets, whose draws come from the global `np.random`.  Port
of `rick_tpu/cli/kid.py`; runs on the card, TF32 off.
"""

from __future__ import annotations

import argparse

from rick_tpu_torch.cli.fid import _load_images, no_tf32
from rick_tpu_torch.metrics import calculate_kid_given_images, default_inception_params, inception_from_params


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser()
    p.add_argument("path", type=str, nargs=2)
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--n_subsets", type=int, default=100)
    args = p.parse_args(argv)
    no_tf32()

    model = inception_from_params(default_inception_params(), device=device)
    imgs0 = _load_images(args.path[0], args.size)
    imgs1 = _load_images(args.path[1], args.size)
    mean, std = calculate_kid_given_images(imgs0, imgs1, model, args.batch_size, n_subsets=args.n_subsets)
    print(f"KID mean std: {mean:.6f} {std:.6f}")


if __name__ == "__main__":
    main()
