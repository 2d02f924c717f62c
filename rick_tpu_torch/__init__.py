"""rick-tpu-torch: the PyTorch / CUDA port of `rick_tpu`, for NVIDIA Hopper.

The JAX package `rick_tpu` stays the reference: every module here keeps the
name and place of its counterpart there, and the tests check each one against
it on the same weights and inputs.

Layering (bottom to top):
  ops    -- resampling (upfirdn2d), fused bias/activation, and the wrappers of
            the hand-written CUDA kernels in `csrc/` (built by `ops/_build.py`
            at first use)
  nn     -- StyleGAN2 generator / discriminator as `nn.Module`s whose
            `state_dict()` keys are the rosinality keys
  ckpt   -- rick_tpu params and train states <-> state dicts and
            `TrainState`, rosinality `.pt` loading and writing, rick_tpu's
            `.state.npz` resume format, the background checkpoint writer
  augment -- ADA: the affine and colour samplers, the antialiased warp,
            `augment`
  train  -- the four phases with the EMA and ADA, Adam, masks, the Fisher
            round, `sample_images`
  metrics -- the in-loop FID evaluator, InceptionV3, the Frechet distance
  data   -- the record store, a PNG codec of its own (no cv2, no PIL), the
            image pipeline
  utils  -- image grids, `stats.jsonl`, a profiler window, the program's own
            spans and counters (`utils/trace.py`)
  cli    -- `python -m rick_tpu_torch.cli.train`, rick_tpu's train CLI

Dispatch is by device and nothing else: a CPU tensor takes each kernel's plain
PyTorch version, a CUDA tensor launches the kernel or raises.  Importing this
package imports neither `jax` nor `triton`, touches no CUDA state and builds
nothing.
"""

__version__ = "0.1.0"
