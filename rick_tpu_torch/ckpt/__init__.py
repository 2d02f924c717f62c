"""Checkpoint layer: rick_tpu params and train states -> state dicts and
`TrainState`, rosinality `.pt` loading."""

from rick_tpu_torch.ckpt.convert import (
    d_masks_from_jax,
    discriminator_state_dict_from_jax,
    g_masks_from_jax,
    generator_state_dict_from_jax,
    load_checkpoint,
    merge_state_dict_lenient,
    train_state_from_jax,
)

__all__ = [
    "d_masks_from_jax",
    "discriminator_state_dict_from_jax",
    "g_masks_from_jax",
    "generator_state_dict_from_jax",
    "load_checkpoint",
    "merge_state_dict_lenient",
    "train_state_from_jax",
]
