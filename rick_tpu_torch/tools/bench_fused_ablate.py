"""Where the fused upsample kernel's time goes: K4 cut after each stage (K5).

    python -m rick_tpu_torch.tools.bench_fused_ablate

Counterpart of `scripts/bench_fused_ablate.py`, whose Pallas stages dma /
matmul / blend / full map to the CUDA kernel's load / conv / blur / full
(`csrc/convt_blur_act.cu`, `ops.convt_blur_act_stage`).  At the three large
upsample shapes of 256px generation at batch 100 (512->512 at 32^2, 512->256
at 64^2, 256->128 at 128^2 input), on seeded inputs as in the JAX script (xs
N(0,1), w N(0,1)*0.05, demod U[0.5,1.5), noise N(0,1)*0.1, bias N(0,1)*0.1,
drawn with a `torch.Generator` on the card), it first holds each stage
against its plain version (`verify`), then times each stage, each stage's
plain version (`convt_blur_act_stage_ref`; the full stage's is the plain
chain `convt_blur_act_ref`) and one `F.conv_transpose2d` of the same input
and weight, with CUDA events after a warm-up.  TF32 is off, so that cuDNN
and the plain versions compute in f32, as the kernel's 3xTF32 does (no TF32
flag reaches the kernel).  Prints one line per shape, as the JAX script does,
then one JSON line with the times and each stage's bytes and operations.
Every stage writes the whole output, so two stages' times differ by the work
of the later one.  Each stage's bound (`stage_bound`) counts its conv at the
route the kernel takes, 3xTF32 on the tensor cores (`tools/roofline.py`); the
table prints it and each stage's share of it.
"""

from __future__ import annotations

import json

import torch
import torch.nn.functional as F

from rick_tpu_torch.ops import STAGES, convt_blur_act, convt_blur_act_stage, convt_blur_act_stage_ref
from rick_tpu_torch.tools.roofline import TF32_PASSES, bound, convt_ops

SHAPES = ((512, 512, 32), (512, 256, 64), (256, 128, 128))  # (Cin, Cout, H) of the input
BATCH = 100
ITERS = 10
# the conv, blur and full stages against their plain versions: max|d| <=
# STAGE_TOL * max|ref| (the kernel sums 9*Cin products in another order than
# cuDNN); the load stage writes exact zeros
STAGE_TOL = 1e-4


def make_inputs(cin: int, cout: int, h: int, batch: int, device, seed: int = 0):
    """(xs, w, demod, noise, bias) of `bench_fused_ablate.py::main`."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    xs = randn(batch, cin, h, h)
    w = randn(cout, cin, 3, 3) * 0.05
    demod = torch.rand((batch, cout), generator=gen, device=device) + 0.5
    noise = randn(batch, 1, 2 * h, 2 * h) * 0.1
    bias = randn(cout) * 0.1
    return xs, w, demod, noise, bias


def stage_work(stage: str, batch: int, cin: int, cout: int, h: int):
    """(bytes, operations) of the function the stage computes: each input it
    needs read once and its output written once; the transposed conv's
    multiply-adds, the blur's (separable: a 4-tap row pass and a 4-tap
    column pass per output) and the epilogue's."""
    y = batch * cout * 4 * h * h
    nbytes = 4 * (batch * cin * h * h + cout * cin * 9 + y)
    flops = 0
    if stage != "load":
        flops += 2 * batch * cin * cout * 9 * h * h
    if stage in ("blur", "full"):
        flops += 2 * 8 * y
    if stage == "full":
        nbytes += 4 * (batch * cout + batch * 4 * h * h + cout)
        flops += 4 * y
    return nbytes, flops


def stage_bound(stage: str, batch: int, cin: int, cout: int, h: int):
    """(least ms, what bounds it) of a stage on the card: its bytes, its
    conv as 3xTF32 on the tensor cores, its blur and epilogue in f32."""
    nbytes, ops = stage_work(stage, batch, cin, cout, h)
    conv = convt_ops(batch, cin, cout, h) if stage != "load" else 0
    return bound(nbytes, ops - conv, TF32_PASSES * conv)


def cuda_ms(fn, iters: int = ITERS) -> float:
    """Mean device time of fn() over `iters` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_stages(args) -> dict:
    """Each stage against its plain version on `args`, and the full stage
    bitwise against `convt_blur_act`; raises on a mismatch.  Returns each
    stage's max abs error."""
    errs = {}
    label = f"{tuple(args[0].shape)}->{args[1].shape[0]}"
    for stage in STAGES:
        got, ref = convt_blur_act_stage(stage, *args), convt_blur_act_stage_ref(stage, *args)
        if got.shape != ref.shape:
            raise RuntimeError(f"K5 {stage} {label}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        err = float((got - ref).abs().max())
        rel = err / max(float(ref.abs().max()), 1e-30)
        if stage == "load" and bool(got.any()):
            raise RuntimeError(f"K5 load {label}: non-zero output")
        if stage != "load" and not rel <= STAGE_TOL:
            raise RuntimeError(f"K5 {stage} {label}: rel err {rel:.3e} > {STAGE_TOL}")
        if stage == "full" and not torch.equal(got, convt_blur_act(*args)):
            raise RuntimeError(f"K5 full {label} is not bitwise convt_blur_act")
        errs[stage] = err
        del got, ref
    return errs


def verify(batch: int = BATCH, shapes=SHAPES, device="cuda", seed: int = 0) -> dict:
    """`check_stages` at each shape, on the inputs `ablate` times (seed
    `seed + i` for the i-th shape); returns each stage's largest max abs
    error."""
    errs = dict.fromkeys(STAGES, 0.0)
    with torch.inference_mode():
        for i, (cin, cout, h) in enumerate(shapes):
            args = make_inputs(cin, cout, h, batch, device, seed=seed + i)
            for stage, e in check_stages(args).items():
                errs[stage] = max(errs[stage], e)
            del args
            torch.cuda.empty_cache()
    return errs


def ablate(batch: int = BATCH, shapes=SHAPES, iters: int = ITERS, device="cuda") -> list:
    """Per shape: the ms of each stage and of its plain version, of one
    `F.conv_transpose2d`, and each stage's (bytes, operations)."""
    rows = []
    with torch.inference_mode():
        for i, (cin, cout, h) in enumerate(shapes):
            args = make_inputs(cin, cout, h, batch, device, seed=i)
            wt = args[1].transpose(0, 1).contiguous()
            rows.append(dict(
                cin=cin, cout=cout, h=h, batch=batch,
                ms={s: cuda_ms(lambda s=s: convt_blur_act_stage(s, *args), iters) for s in STAGES},
                plain_ms={s: cuda_ms(lambda s=s: convt_blur_act_stage_ref(s, *args), iters) for s in STAGES},
                conv_transpose2d_ms=cuda_ms(lambda: F.conv_transpose2d(args[0], wt, stride=2), iters),
                work={s: stage_work(s, batch, cin, cout, h) for s in STAGES},
            ))
            del args, wt
            torch.cuda.empty_cache()
    return rows


def format_row(r: dict) -> str:
    """One shape's stage times, cuDNN's and the plain chain's, then each
    stage's bound and its share of it (bound / time)."""
    bounds = {s: stage_bound(s, r["batch"], r["cin"], r["cout"], r["h"])[0] for s in STAGES}
    return (f"{r['cin']}->{r['cout']} @{r['h']}px: " + "  ".join(f"{s}={t:.3f}" for s, t in r["ms"].items())
            + f"  conv_transpose2d={r['conv_transpose2d_ms']:.3f}  plain chain={r['plain_ms']['full']:.3f}"
            + f"  (ms, batch {r['batch']})\n    bound ms (share): "
            + "  ".join(f"{s}={bounds[s]:.3f} ({bounds[s] / r['ms'][s]:.0%})" for s in STAGES))


def main() -> None:
    from rick_tpu_torch.tools.profile_gen import start_on_card

    card = start_on_card("bench_fused_ablate")
    errs = verify()
    print(f"each stage vs plain at batch {BATCH} (tolerance {STAGE_TOL} * max|ref|), max abs err: {errs}")
    rows = ablate()
    for r in rows:
        print(format_row(r))
    print(json.dumps({"card": card, "tf32": False, "rows": rows}))


if __name__ == "__main__":
    main()
