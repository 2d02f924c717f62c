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
  ckpt   -- rick_tpu params -> state dicts, rosinality `.pt` loading
  train  -- `sample_images` (the forward-only slice of training)
  utils  -- image grids

Dispatch is by device and nothing else: a CPU tensor takes each kernel's plain
PyTorch version, a CUDA tensor launches the kernel or raises.  Importing this
package imports neither `jax` nor `triton`, touches no CUDA state and builds
nothing.
"""

__version__ = "0.1.0"
