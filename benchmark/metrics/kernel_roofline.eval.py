"""kernel_roofline.eval: the port's K3 and K4 (`ops/kernels.py`,
`ops/fused_upsample.py` -> `csrc/modconv_epilogue.cu`,
`csrc/convt_blur_act.cu`) in the traced evaluation: the sum of each launch's
bound over the sum of those kernels' device time, in %."""

from benchmark.metrics_common import roofline_share


def read(record):
    return roofline_share(record, ("rick_modconv_epilogue", "rick_convt_blur_act_stage"))
