"""kernel_roofline.train: the port's K1, K2 and K3 (`ops/kernels.py` ->
`csrc/fused_bias_act.cu`, `csrc/modconv_epilogue.cu`) in the traced block:
the sum of each launch's bound (`roofline.launch_bound`, from the launch's
shape) over the sum of those kernels' device time, in %."""

from benchmark.metrics_common import roofline_share


def read(record):
    return roofline_share(record, ("rick_fused_bias_act", "rick_fused_bias_act_bwd", "rick_modconv_epilogue"))
