"""kernel_roofline.eval: the port's K4 and K6 (`ops/fused_upsample.py`,
`ops/modconv_act.py` -> `csrc/convt_blur_act.cu`, `csrc/modconv_act.cu`), G's
upsampling and stride-1 StyledConvs, in the traced evaluation: the sum of
each launch's bound over the sum of those kernels' device time, in %."""

from benchmark.metrics_common import roofline_share


def read(record):
    return roofline_share(record, ("rick_convt_blur_act_stage", "rick_modconv_act"))
