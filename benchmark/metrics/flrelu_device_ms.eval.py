"""flrelu_device_ms.eval: the device time of StyleGAN3's filtered leaky
ReLU in the traced evaluation: each device record launched inside the
program's span `sg3.filtered_lrelu` (`rick_tpu_torch/nn/stylegan3.py`, 15 a
chunk: 14 layers and ToRGB), per evaluation, in ms."""

from benchmark.layer_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "sg3.filtered_lrelu", "evaluation")
