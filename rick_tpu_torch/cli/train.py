"""Training CLI of the port: `python -m rick_tpu_torch.cli.train`, with the
flags of `rick_tpu.cli.train` (the reference's `train_dynamic_update_prune.py`
flags plus rick_tpu's).  Port of `rick_tpu/cli/train.py`.

It runs on the card; `main(argv, device="cpu")` runs the same loop on the
CPU.  `--bf16` runs the D and G phases with the compute dtype bf16, as
rick_tpu's (`train/steps.py`).

Data-parallel: `torchrun --nproc_per_node N -m rick_tpu_torch.cli.train ...`
runs one rank per card (NCCL; gloo on the CPU) over the global `--batch`:
each rank trains on its rows with the gradients all-reduced, the Fisher
images and the evaluation's samples are sharded, and rank 0 alone writes
files, logs and grids (`dist/`, `train/steps.py`).  `--n_devices` must be 0
(every rank) or the world size.
TF32 is off for cuDNN and matmuls: f32 is the precision every parity check
of the port holds.

Artifacts are `rick_tpu`'s: `args.txt`, the script copy, the few-shot index,
`stats.jsonl`, sample grids, `{i:06d}.state.npz` (rick_tpu's resume format,
so a run resumes across the two packages) with `{i:06d}.pt` (the reference's
5-key layout), and `best.pt` / `best_fid.txt`.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import glob
import hashlib
import os
import random
import shutil
import time

import numpy as np
import torch

from rick_tpu_torch.ckpt import (
    load_checkpoint,
    load_state,
    save_state,
    state_dicts,
    torch_checkpoint,
    train_state_from_jax,
    train_state_to_jax,
)
from rick_tpu_torch.ckpt.async_io import AsyncSaver, Snapshot, atomic_write
from rick_tpu_torch.data import ImageDataset, NativeImageDataset, data_stream, device_data_stream, get_nsamples
from rick_tpu_torch.dist import (
    all_gather_rows,
    initialize_multihost,
    is_main_process,
    launched_world_size,
    local_batch_size,
    rank,
)
from rick_tpu_torch.metrics import Evaluator
from rick_tpu_torch.nn import Discriminator, DiscriminatorConfig, Generator, GeneratorConfig
from rick_tpu_torch.train import (
    TrainConfig,
    fisher_round,
    init_train_state,
    merge_prune,
    replicate_train_state,
    run_iteration,
    sample_images,
)
from rick_tpu_torch.utils import ProfilerHook, StatsLogger, save_image_grid

# the tags of an iteration's draws: its phases, and its Fisher round
PHASES_TAG, FISHER_TAG = 0, 3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="rick-tpu few-shot StyleGAN2 adaptation (PyTorch port)")
    # `train_dynamic_update_prune.py:703-758`
    p.add_argument("--exp", type=str, default="tmp")
    p.add_argument("--data_path", type=str, default="babies")
    p.add_argument("--iter", type=int, default=31)
    p.add_argument("--highp", type=int, default=1)
    p.add_argument("--subspace_freq", type=int, default=4)
    p.add_argument("--feat_ind", type=int, default=3)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--feat_const_batch", type=int, default=4)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--patch_size", type=int, default=4)
    p.add_argument("--feat_res", type=int, default=128)
    p.add_argument("--r1", type=float, default=10)
    p.add_argument("--path_regularize", type=float, default=2)
    p.add_argument("--path_batch_shrink", type=int, default=2)
    p.add_argument("--d_reg_every", type=int, default=16)
    p.add_argument("--g_reg_every", type=int, default=4)
    p.add_argument("--mixing", type=float, default=0.9)
    p.add_argument("--subspace_std", type=float, default=0.05)
    p.add_argument("--ckpt_source", type=str, default="style_gan_source_ffhq.pt")
    p.add_argument("--source_key", type=str, default="ffhq")
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--augment", dest="augment", action="store_true")
    p.add_argument("--no-augment", dest="augment", action="store_false")
    p.set_defaults(augment=False)
    p.add_argument("--augment_p", type=float, default=0.0)
    p.add_argument("--ada_target", type=float, default=0.6)
    p.add_argument("--ada_length", type=int, default=500 * 1000)
    p.add_argument("--n_sample_train", type=int, default=10)
    p.add_argument("--n_sample_store", type=int, default=25)
    p.add_argument("--n_sample_test", type=int, default=25)
    p.add_argument("--store_checkpoints", action="store_true")
    p.add_argument("--store_samples", action="store_true")
    p.add_argument("--eval_in_training", action="store_true")
    p.add_argument("--num_fisher_img", type=int, default=5)
    p.add_argument("--fisher_freq", type=int, default=2)
    p.add_argument("--fisher_coef", type=float, default=1.0)
    p.add_argument("--fisher_quantile", type=float, default=75)
    p.add_argument("--prune_quantile", type=float, default=0.1)
    p.add_argument("--warmup_iter", type=int, default=10)
    p.add_argument("--checkpoints_freq", type=int, default=500)
    p.add_argument("--samples_freq", type=int, default=500)
    p.add_argument("--eval_in_training_freq", type=int, default=500)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--wandb_project_name", type=str, default="debug")
    p.add_argument("--wandb_run_name", type=str, default="debug")
    p.add_argument("--method", type=str, default="dynamic_1")
    # rick_tpu's additions (defaults keep the reference layout)
    p.add_argument("--data_root", type=str, default="../../")
    p.add_argument("--output_root", type=str, default="../../_output_style_gan")
    p.add_argument("--sample_noise", type=str, default="./noise.pt")
    p.add_argument("--fisher_noise_dir", type=str, default="./_noise")
    p.add_argument("--allow_random_fisher_noise", action="store_true",
                   help="substitute seeded random latents for missing _noise/*.pt fixtures instead of failing "
                        "(deviates from the reference Fisher protocol)")
    p.add_argument("--ada_margin", type=int, default=224,
                   help="static reflect-pad margin for the ADA warp; rotated samples deviate at the borders "
                        "unless it covers the rotation worst case (~0.87 * size)")
    p.add_argument("--eval_bf16", action="store_true", help="bfloat16 InceptionV3 feature extraction during eval")
    p.add_argument("--eval_nhwc", action="store_true", help="run the eval InceptionV3 in channels_last")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute for the D/G adversarial phases "
                        "(params/optimizer/regularizers stay f32)")
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--auto_resume", action="store_true",
                   help="resume from the latest .state.npz in the checkpoint dir")
    p.add_argument("--n_devices", type=int, default=0,
                   help="0 = every rank of the launch (one per card, torchrun); else the world size")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--profile_dir", type=str, default="", help="enable torch.profiler traces")
    return p


def check_n_devices(args) -> None:
    """`--n_devices` must be 0 or the launch's world size (one process per
    card takes the place of rick_tpu's one process driving N devices)."""
    world = launched_world_size() or 1
    if args.n_devices not in (0, world):
        raise ValueError(f"--n_devices {args.n_devices}: this launch has {world} rank(s); start N ranks with "
                         "torchrun --nproc_per_node N, and pass 0 or N")


def iteration_generator(device, seed: int, i: int, tag: int) -> torch.Generator:
    """The generator of iteration i's draws of kind `tag`, seeded from
    (seed, i, tag) alone: a resumed run draws at iteration i what a
    continuous run draws, as `rick_tpu`'s fold_in(fold_in(key, i), tag)."""
    s = np.random.SeedSequence([seed + 7, i, tag]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def load_fisher_noises(noise_dir, num_fisher_img, latent, batch, *, allow_random=False, log=print):
    """The fixed `_noise/{j:04d}.pt` Fisher latents: (noises (sum(rows),
    latent) float32, rows per file).  Every row of a file is one FIM
    sample, paired with a row of one real batch
    (`train_dynamic_update_prune.py:227-236`).

    Missing files raise unless `allow_random`; then each is replaced by one
    seeded row, from `torch.Generator().manual_seed(1000 + j)` (`rick_tpu`
    draws it from `jax.random.key(1000 + j)`: the two differ)."""
    noises, rows, missing = [], [], []
    for j in range(num_fisher_img):
        fpath = os.path.join(noise_dir, f"{j:04d}.pt")
        if os.path.exists(fpath):
            r = torch.as_tensor(torch.load(fpath, map_location="cpu", weights_only=True), dtype=torch.float32)
            r = r.reshape(-1, latent).numpy()
            if r.shape[0] > batch:
                raise ValueError(f"{fpath} has {r.shape[0]} rows > batch {batch}; the reference pairs each row "
                                 "with a row of one real batch")
        else:
            missing.append(fpath)
            r = torch.randn((1, latent), generator=torch.Generator().manual_seed(1000 + j)).numpy()
        noises.append(r)
        rows.append(r.shape[0])
    if missing:
        if not allow_random:
            raise FileNotFoundError(
                f"Fisher noise fixtures missing: {missing[:3]}{' ...' if len(missing) > 3 else ''} "
                f"({len(missing)}/{num_fisher_img} files under {noise_dir!r}). These fix the Fisher-information "
                "sampling protocol (reference train_dynamic_update_prune.py:227-236); running without them "
                "silently diverges from it. Provide the files or pass --allow_random_fisher_noise to substitute "
                "seeded random latents."
            )
        log(f"WARNING: {len(missing)}/{num_fisher_img} Fisher noise fixtures missing under {noise_dir!r}; "
              "substituting seeded random latents (--allow_random_fisher_noise). Fisher scores will NOT match "
              "runs that use the reference fixtures.", flush=True)
    return np.concatenate(noises, axis=0), rows


# a training set up to this size (decoded, f32) is staged on the device;
# larger ones stream from the host thread, as rick_tpu's
STAGED_BYTES_MAX = 512 << 20


def open_dataset(path: str, size: int, **kw):
    """The training set at `path`, as `rick_tpu`'s `open_dataset`: a record
    store (`records.rdb`) through the threaded batch decoder
    (`NativeImageDataset`), an lmdb store through `ImageDataset`, which is
    where `rick_tpu`'s native open fails.  Decided by the store's format,
    not by catching an error: a failed build or decode stops the run."""
    if os.path.exists(os.path.join(path, "records.rdb")):
        return NativeImageDataset(path, resolution=size, **kw)
    return ImageDataset(path, resolution=size, **kw)


def _dataset_fingerprint(path: str) -> str:
    """Content fingerprint of a dataset directory, for real-set cache keys:
    the store file's (size, mtime_ns), or for a plain image directory
    (entry count, newest mtime_ns)."""
    for fname in ("records.rdb", "data.mdb"):
        f = os.path.join(path, fname)
        if os.path.exists(f):
            st = os.stat(f)
            return f"{st.st_size:x}.{st.st_mtime_ns:x}"
    if not os.path.isdir(path):
        return "nofp"
    n, newest = 0, 0
    with os.scandir(path) as it:
        for e in it:
            n += 1
            newest = max(newest, e.stat().st_mtime_ns)
    return f"d{n:x}.{newest:x}"


def _inception_tag() -> str:
    """Which Inception weights the port's real activations come from: the
    seeded init, or the file `RICK_INCEPTION_WEIGHTS` names (path, size,
    mtime)."""
    path = os.environ.get("RICK_INCEPTION_WEIGHTS", "")
    if not path:
        return "torch-seeded0"
    st = os.stat(path)
    return f"torch-{hashlib.sha256(os.path.abspath(path).encode()).hexdigest()[:8]}.{st.st_size:x}.{st.st_mtime_ns:x}"


def _real_cache_paths(args, test_path: str, cache_dir: str):
    """(real_imgs, real_acts) cache paths for this run's real-set key.

    The uint8 images are the same bytes in both packages, so their file has
    `rick_tpu`'s name and is shared.  The activations are not: `rick_tpu`'s
    seeded Inception comes from `jax.random`, the port's from numpy
    (`inception_init_np(0)`), so the port's file carries a tag of its
    Inception weights and cannot be mistaken for `rick_tpu`'s."""
    safe_data_path = args.data_path.replace(os.sep, "_").replace("/", "_")
    fp = _dataset_fingerprint(test_path)
    cache_key = f"{safe_data_path}_{args.size}px_{args.n_sample_test}_s{args.seed}_{fp}"
    real_imgs = os.path.join(cache_dir, f"real_imgs_{cache_key}.npy")
    real_acts = os.path.join(
        cache_dir,
        f"real_acts_{cache_key}{'_bf16' if args.eval_bf16 else ''}{'_nhwc' if args.eval_nhwc else ''}"
        f"_{_inception_tag()}.npy",
    )
    return real_imgs, real_acts


def _evict_stale_real_caches(cache_dir: str, keep_keys) -> None:
    """Delete real-set cache files whose name is not in `keep_keys`
    (RICK_CLEAR_REAL_CACHE=1): ~1 GB each at 256px / 5k samples."""
    keep = {os.path.basename(k) for k in keep_keys}
    for f in glob.glob(os.path.join(cache_dir, "real_imgs_*.npy")) + glob.glob(
            os.path.join(cache_dir, "real_acts_*.npy")):
        if os.path.basename(f) not in keep and os.path.exists(f):
            os.remove(f)
            print(f"evicted stale real-set cache {f}")


def _save_npy(path: str, arr: np.ndarray) -> None:
    """Atomic, with a per-process tmp name: concurrent runs on one dataset
    must not interleave writes into one tmp file."""
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, arr)
    os.replace(tmp, path)


def _save_torch_ckpt(path: str, host_state, tcfg: TrainConfig) -> None:
    """The reference's 5-key checkpoint {g_ema, g, d, g_optim, d_optim}
    (`:644-659`), atomically.  `host_state` is a host snapshot of
    `state_dicts(state)`."""
    with atomic_write(path) as tmp:
        torch.save(torch_checkpoint(host_state, tcfg), tmp)


def _write_periodic(host_state, *, ckpt_dir, step, best_fid, gcfg, dcfg, tcfg) -> None:
    # the npz first: it is what --auto_resume reads
    save_state(os.path.join(ckpt_dir, f"{step:06d}.state.npz"), train_state_to_jax(host_state, gcfg, dcfg),
               step=step, extra={"best_fid": best_fid} if best_fid < 1000.0 else None)
    _save_torch_ckpt(os.path.join(ckpt_dir, f"{step:06d}.pt"), host_state, tcfg)


def _write_best(host_state, *, ckpt_dir, fid, tcfg) -> None:
    _save_torch_ckpt(os.path.join(ckpt_dir, "best.pt"), host_state, tcfg)
    np.savetxt(os.path.join(ckpt_dir, "best_fid.txt"), np.asarray([fid]).reshape(1, -1))


def main(argv=None, *, device="cuda") -> dict:
    """Run the training loop; returns a summary (start iteration, counts of
    iterations, Fisher rounds and evaluations, best FID, seconds).  Under
    torchrun, joins the process group first and leaves it at the end."""
    args = build_parser().parse_args(argv)
    check_n_devices(args)
    joins = not torch.distributed.is_initialized()
    with contextlib.ExitStack() as stack:
        group, device = initialize_multihost(device)
        if group is not None and joins:
            stack.callback(torch.distributed.destroy_process_group)
        return run_training(args, group, device)


def run_training(args, group, device) -> dict:
    """The loop of `main` on `device`, as one rank of `group` (None: the
    only process)."""
    is_main = is_main_process(group)
    say = print if is_main else (lambda *a, **k: None)
    local_batch_size(args.batch, group)  # a batch that does not divide raises here

    random.seed(args.seed)
    np.random.seed(args.seed)
    device = torch.device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args.tf32 = False  # recorded in args.txt

    # ---- dirs (`:771-781`)
    args.output_path = os.path.join(args.output_root, args.exp)
    args.sample_dir = os.path.join(args.output_path, "samples")
    args.checkpoint_dir = os.path.join(args.output_path, "checkpoints")
    for d in (args.output_path, args.sample_dir, args.checkpoint_dir):
        if is_main:
            os.makedirs(d, exist_ok=True)
    args.latent, args.n_mlp, args.start_iter = 512, 8, 0

    # ---- configs
    gcfg = GeneratorConfig(size=args.size, channel_multiplier=args.channel_multiplier)
    dcfg = DiscriminatorConfig(size=args.size, channel_multiplier=args.channel_multiplier)
    tcfg = TrainConfig(
        batch=args.batch, r1=args.r1, path_regularize=args.path_regularize,
        path_batch_shrink=args.path_batch_shrink, d_reg_every=args.d_reg_every, g_reg_every=args.g_reg_every,
        mixing=args.mixing, lr=args.lr, augment=args.augment, augment_p=args.augment_p,
        ada_target=args.ada_target, ada_length=args.ada_length, ada_margin=args.ada_margin,
        warmup_iter=args.warmup_iter, fisher_freq=args.fisher_freq, num_fisher_img=args.num_fisher_img,
        fisher_quantile=args.fisher_quantile, prune_quantile=args.prune_quantile, bf16=args.bf16,
    )

    # ---- data (`:789-843`)
    train_path = os.path.join(args.data_root, "_processed_train", args.data_path)
    test_path = os.path.join(args.data_root, "_processed_test", args.data_path)
    if args.n_sample_train == 10:
        train_ds = open_dataset(train_path, args.size)
    else:
        base = ImageDataset(test_path, resolution=args.size)
        few_shot_idx = np.random.choice(len(base), size=args.n_sample_train, replace=False)  # equal on every rank
        if is_main:
            np.savetxt(os.path.join(args.output_path, f"{args.n_sample_train}-shot-index.txt"), few_shot_idx)
        train_ds = open_dataset(test_path, args.size, indices=few_shot_idx)
        say(f"Few-shot transfer with {few_shot_idx.size}-shot images")
    # A few-shot set is staged whole on the device: each batch is then a
    # gather and a flip there, and the host, which already bounds the
    # training phases, neither decodes nor copies per iteration.  Larger sets
    # stream from the host thread, each rank its rows with a seed of its own.
    staged_bytes = len(train_ds) * 3 * args.size * args.size * 4
    if staged_bytes <= STAGED_BYTES_MAX:
        train_loader = device_data_stream(train_ds, args.batch, seed=args.seed, device=device, group=group)
    else:
        train_loader = data_stream(train_ds, local_batch_size(args.batch, group), seed=args.seed + 7919 * rank(group),
                                   device=device)

    # ---- args.txt (`:845-851`) and the script copy (`:853-857`), rank 0 only (`:605`)
    if is_main:
        with open(os.path.join(args.output_path, "args.txt"), "w") as f:
            f.writelines("------------------ start ------------------\n")
            for k, v in vars(args).items():
                f.writelines(f"{k} : {v}\n")
            f.writelines("------------------- end -------------------")
        shutil.copy(os.path.abspath(__file__), os.path.join(args.output_path, "train_script.py"))

    # ---- models + source checkpoint (`:864-879`)
    wgen = torch.Generator(device=device).manual_seed(args.seed)
    g = Generator(gcfg.size, gcfg.style_dim, gcfg.n_mlp, gcfg.channel_multiplier, rng=wgen, device=device)
    d = Discriminator(dcfg.size, dcfg.channel_multiplier, rng=wgen, device=device)
    g_ema = None
    ckpt_path = os.path.join(args.data_root, "_pretrained", args.ckpt_source)
    if args.ckpt_source and os.path.exists(ckpt_path):
        if args.source_key not in args.ckpt_source:
            raise ValueError(f"--source_key {args.source_key!r} is not in --ckpt_source {args.ckpt_source!r}")
        say("load model:", args.ckpt_source)
        g_ema = copy.deepcopy(g)  # the checkpoint's g_ema merged over G's init, as rick_tpu does
        load_checkpoint(ckpt_path, device, g=g, g_ema=g_ema, d=d)
    state = init_train_state(gcfg, dcfg, tcfg, rng=wgen, device=device, g=g, d=d)
    if g_ema is not None:
        state.g_ema.load_state_dict(g_ema.state_dict())
    del g, d, g_ema

    start_iter = 0
    resume_path = args.resume
    if not resume_path and args.auto_resume:
        candidates = sorted(glob.glob(os.path.join(args.checkpoint_dir, "*.state.npz")))
        if candidates:
            resume_path = candidates[-1]
    resumed_best_fid = None
    if resume_path:  # every rank reads the file; rank 0's state is broadcast below
        tree, manifest = load_state(resume_path)
        state = train_state_from_jax(gcfg, dcfg, tree, tcfg=tcfg, device=device)
        start_iter = int(manifest.get("step", 0))
        # the best-FID watermark, so that the first evaluation after the
        # resume cannot overwrite best.pt with a worse model: the lower of
        # the checkpoint's and best_fid.txt's (rick_tpu takes the
        # checkpoint's alone, which misses a best found after it was saved)
        marks = [float(manifest["best_fid"])] if "best_fid" in manifest else []
        bf_txt = os.path.join(args.checkpoint_dir, "best_fid.txt")
        if os.path.exists(bf_txt):
            marks.append(float(np.loadtxt(bf_txt).reshape(-1)[0]))
        resumed_best_fid = min(marks) if marks else None
        say(f"resumed from {resume_path} at iter {start_iter}"
            + (f" (best FID so far {resumed_best_fid:.3f})" if resumed_best_fid is not None else ""), flush=True)
    replicate_train_state(state, group)

    # ---- evaluator (`:947-958`).  The real set's caches depend only on
    # {dataset, size, n_sample_test, seed}, so they live beside the dataset
    # and every run and resume on it shares them.
    evaluator = None
    cache_dir = os.path.join(args.data_root, "_cache")
    real_imgs_cache, real_acts_cache = _real_cache_paths(args, test_path, cache_dir)
    if is_main:
        os.makedirs(cache_dir, exist_ok=True)
        if os.environ.get("RICK_CLEAR_REAL_CACHE") == "1":
            _evict_stale_real_caches(cache_dir, [real_imgs_cache, real_acts_cache])
    if args.eval_in_training:
        if os.path.exists(real_imgs_cache):
            x_real_test = np.load(real_imgs_cache)
        else:
            test_ds = ImageDataset(test_path, resolution=args.size, flip=True)
            x_real_f32 = get_nsamples(test_ds, args.n_sample_test, seed=args.seed)
            x_real_test = np.clip(np.rint((x_real_f32 + 1.0) * 127.5), 0, 255).astype(np.uint8)
            if is_main:
                _save_npy(real_imgs_cache, x_real_test)
        real_acts = np.load(real_acts_cache) if os.path.exists(real_acts_cache) else None
        evaluator = Evaluator(
            gcfg, fid_real_samples=x_real_test, inception_nsamples=args.n_sample_test,
            batch_size=max(args.batch, 25), n_sample_store=args.n_sample_store,
            inception_dtype=torch.bfloat16 if args.eval_bf16 else torch.float32,
            inception_nhwc=args.eval_nhwc, real_acts=real_acts, device=device, group=group,
        )
        if is_main:
            if real_acts is None:
                _save_npy(real_acts_cache, evaluator._real_acts)
            x_real = get_nsamples(train_ds, 10)
            save_image_grid(torch.from_numpy(x_real), os.path.join(args.output_path, "real.png"), nrow=5)

    # ---- fixed latents
    if os.path.exists(args.sample_noise):
        sample_z = torch.as_tensor(torch.load(args.sample_noise, map_location="cpu", weights_only=True),
                                   dtype=torch.float32)
    else:
        say(f"WARNING: fixed sample latents {args.sample_noise!r} not found; using seeded random latents "
            "(torch.Generator seed 0) - sample grids will not match runs that use the reference noise.pt "
            "fixture.", flush=True)
        sample_z = torch.randn((args.n_sample_store, args.latent), generator=torch.Generator().manual_seed(0))
    sample_z = sample_z.to(device)
    fisher_noises, fisher_rows = load_fisher_noises(args.fisher_noise_dir, args.num_fisher_img, args.latent,
                                                    args.batch, allow_random=args.allow_random_fisher_noise, log=say)
    fisher_noises = torch.from_numpy(fisher_noises).to(device)

    # ---- training loop (`:159-699`)
    best_fid = resumed_best_fid if resumed_best_fid is not None else 1000.0
    t_start = time.time()
    log_every = 50
    stats = StatsLogger(args.output_path, use_wandb=args.wandb, project=args.wandb_project_name,
                        run_name=args.wandb_run_name) if is_main else None
    saver = AsyncSaver(max_pending=2) if is_main else None
    best_dirty = None  # (snapshot, fid) of the newest best not yet submitted
    last_best_save = 0.0
    best_save_interval = float(os.environ.get("RICK_BEST_SAVE_INTERVAL_S", "60"))
    profiler = ProfilerHook(args.profile_dir if is_main else "", start_iter=max(start_iter + 5, args.warmup_iter + 2))
    write_best = functools.partial(_write_best, ckpt_dir=args.checkpoint_dir, tcfg=tcfg)
    done = {"start_iter": start_iter, "iterations": 0, "fisher_rounds": 0, "evaluations": 0}
    # to --iter + 10 inclusive, as rick_tpu (`:527`)
    for i in range(start_iter, args.iter + 10 + 1):
        profiler.step(i)

        # Fisher round (`:213-393`): one real batch per noise file, rows
        # paired index for index (`:228-237`); the global batch's rows
        if i >= args.warmup_iter and (i - args.warmup_iter) % args.fisher_freq == 0:
            reals = torch.cat([all_gather_rows(next(train_loader), group)[:r] for r in fisher_rows])
            gf, gp, df, dp = fisher_round(
                state.g_ema, state.d_ema, fisher_noises, reals, batch=args.batch,
                fisher_quantile=args.fisher_quantile, prune_quantile=args.prune_quantile,
                denom=float(args.num_fisher_img * args.batch),
                gen=iteration_generator(device, args.seed, i, FISHER_TAG), group=group,
            )
            state.g_freeze, state.d_freeze = gf, df
            if i == args.warmup_iter:
                state.g_prune, state.d_prune = gp, dp
            else:
                state.g_prune = merge_prune(state.g_prune, gp)
                state.d_prune = merge_prune(state.d_prune, dp)
            done["fisher_rounds"] += 1

        real = next(train_loader)
        metrics = run_iteration(state, tcfg, real, i, gen=iteration_generator(device, args.seed, i, PHASES_TAG),
                                group=group)
        done["iterations"] += 1

        if is_main and i % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            stats.log(i, m)
            print(f"[{i}/{args.iter}] d: {m['d']:.4f}; g: {m['g']:.4f}; r1: {m['r1']:.4f}; "
                  f"path: {m['path']:.4f}; mean path: {m['mean_path_length']:.4f}; "
                  f"augment: {m['ada_p']:.4f}; {time.time() - t_start:.1f}s elapsed", flush=True)

        if is_main and args.store_samples and i % args.samples_freq == 0:
            grid = sample_images(state.g_ema, sample_z)
            save_image_grid(grid, os.path.join(args.sample_dir, f"{i:06d}.png"), nrow=int(args.n_sample_store**0.5))

        if is_main and args.store_checkpoints and i % args.checkpoints_freq == 0 and i > 0:
            saver.submit(functools.partial(_write_periodic, ckpt_dir=args.checkpoint_dir, step=i, best_fid=best_fid,
                                           gcfg=gcfg, dcfg=dcfg, tcfg=tcfg), Snapshot(state_dicts(state)))

        if evaluator is not None and i % args.eval_in_training_freq == 0:
            score = evaluator.compute_inception_score(state.g_ema)
            done["evaluations"] += 1
            say(f"[{i}] FID: {score['fid']:.3f}", flush=True)
            if is_main:
                stats.log(i, {"fid": float(score["fid"])})
            if score["fid"] < best_fid:
                best_fid = score["fid"]
                best_dirty = (Snapshot(state_dicts(state)), best_fid) if is_main else None
            # throttled: the newest best is flushed at the end regardless
            if best_dirty is not None and time.time() - last_best_save >= best_save_interval:
                snap, fid = best_dirty
                best_dirty = None
                last_best_save = time.time()
                saver.submit_latest("best", functools.partial(write_best, fid=fid), snap)

    profiler.close(args.iter + 10 + 1)
    train_loader.close()
    if is_main:
        if best_dirty is not None:
            snap, fid = best_dirty
            saver.submit_latest("best", functools.partial(write_best, fid=fid), snap)
        saver.close()
        stats.close()
    done.update(best_fid=best_fid, seconds=time.time() - t_start)
    say(f"done in {done['seconds']:.1f}s; best FID {best_fid}", flush=True)
    return done


if __name__ == "__main__":
    main()
