"""sg3_conv_device_ms.eval: the device time of StyleGAN3's modulated convs
in the traced evaluation: each device record launched inside the program's
span `sg3.modconv` (`rick_tpu_torch/nn/stylegan3.py`: each layer's affine,
weight and style normalization and conv; K6 for the 14 3x3 convs), per
evaluation, in ms."""

from benchmark.layer_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "sg3.modconv", "evaluation")
