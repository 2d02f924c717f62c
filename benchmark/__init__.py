"""The benchmark of the PyTorch and CUDA port `rick_tpu_torch` on an NVIDIA
H100: a harness driven by the data in `BENCHMARK.json` and the files beside
this one (`spec.py`), with its own plain reference (`reference/`), FLOP
counter (`flops.py`) and roofline arithmetic (`roofline.py`)."""
