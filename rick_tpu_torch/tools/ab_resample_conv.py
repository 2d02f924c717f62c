"""A/B of upfirdn2d's convolution in the 256px batch-2 training phases.

    python -m rick_tpu_torch.tools.ab_resample_conv

Side A runs upfirdn2d's depthwise convolution through PyTorch's own
`F.conv2d`; side B through `ops/conv.py`, as the port does.  In one process,
in the order A B B A A B B A, each of the four phases (D, R1, G, path
length; after warmup) is timed by CUDA events over 5 calls after a warm-up
(R1 on side A over 1 call: it takes seconds).  Then side A's R1 phase is
profiled with input shapes, and the operators with the most device time are
printed: PyTorch's convolution double backward computes the weight term of
the fixed FIR kernel as a convolution whose filter is the first gradient.
TF32 is off, as in chip_smoke.py.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from rick_tpu_torch.nn import DiscriminatorConfig, GeneratorConfig
from rick_tpu_torch.ops import conv, resample
from rick_tpu_torch.tools.profile_gen import start_on_card
from rick_tpu_torch.train import TrainConfig, init_train_state, sample_draws
from rick_tpu_torch.train import steps

SIDES = {
    "A F.conv2d": lambda x, w, stride: F.conv2d(x, w, stride=stride),
    "B ops.conv": conv.conv2d,
}
ORDER = ["A F.conv2d", "B ops.conv", "B ops.conv", "A F.conv2d"] * 2


def _ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    start_on_card("ab_resample_conv")
    dev = "cuda"
    gcfg, dcfg = GeneratorConfig(256), DiscriminatorConfig(256)
    tcfg = TrainConfig(batch=2, augment=False, warmup_iter=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_train_state(gcfg, dcfg, tcfg, rng=gen, device=dev)
    real = torch.randn((tcfg.batch, 3, 256, 256), generator=gen, device=dev)
    phases = {
        "D": lambda: steps.d_phase(state, tcfg, real, sample_draws(gen, gcfg, tcfg, tcfg.batch), False),
        "R1": lambda: steps.r1_phase(state, tcfg, real, False),
        "G": lambda: steps.g_phase(state, tcfg, sample_draws(gen, gcfg, tcfg, tcfg.batch), False, True),
        "path": lambda: steps.path_phase(state, tcfg, sample_draws(gen, gcfg, tcfg, 1, path=True), False),
    }
    original = resample.conv2d
    for side in ORDER:
        resample.conv2d = SIDES[side]
        row = {k: _ms(fn, 1 if (k == "R1" and side.startswith("A")) else 5) for k, fn in phases.items()}
        print(side, " ".join(f"{k} {v:.2f} ms" for k, v in row.items()), flush=True)
    resample.conv2d = SIDES["A F.conv2d"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        phases["R1"]()
        torch.cuda.synchronize()
    resample.conv2d = original
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
    print("side A, R1 phase, operators by self device time:")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:5]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<3d} {e.key} {e.input_shapes}")


if __name__ == "__main__":
    main()
