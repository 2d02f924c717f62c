"""Checkpoint layer: rick_tpu params and train states <-> state dicts and
`TrainState`, rosinality `.pt` loading and writing, NVlabs' StyleGAN3 G_ema
state dicts, full-state `.npz` checkpoints in rick_tpu's format, and the
background writer."""

from rick_tpu_torch.ckpt.convert import (
    d_masks_from_jax,
    d_optim_state_dict,
    discriminator_params_from_state_dict,
    discriminator_state_dict_from_jax,
    g_masks_from_jax,
    g_optim_state_dict,
    generator3_state_dict_from_nvlabs,
    generator_params_from_state_dict,
    generator_state_dict_from_jax,
    inception_state_dict_from_jax,
    load_checkpoint,
    merge_state_dict_lenient,
    state_dicts,
    torch_checkpoint,
    train_state_from_jax,
    train_state_to_jax,
    vgg16_state_dict_from_jax,
)
from rick_tpu_torch.ckpt.native import load_state, save_state

__all__ = [
    "d_masks_from_jax",
    "d_optim_state_dict",
    "discriminator_params_from_state_dict",
    "discriminator_state_dict_from_jax",
    "g_masks_from_jax",
    "g_optim_state_dict",
    "generator3_state_dict_from_nvlabs",
    "generator_params_from_state_dict",
    "generator_state_dict_from_jax",
    "inception_state_dict_from_jax",
    "load_checkpoint",
    "load_state",
    "merge_state_dict_lenient",
    "save_state",
    "state_dicts",
    "torch_checkpoint",
    "train_state_from_jax",
    "train_state_to_jax",
    "vgg16_state_dict_from_jax",
]
