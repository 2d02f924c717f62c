"""Checkpoint layer: rick_tpu params -> state dicts, rosinality `.pt` loading."""

from rick_tpu_torch.ckpt.convert import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    load_checkpoint,
    merge_state_dict_lenient,
)

__all__ = [
    "discriminator_state_dict_from_jax",
    "generator_state_dict_from_jax",
    "load_checkpoint",
    "merge_state_dict_lenient",
]
