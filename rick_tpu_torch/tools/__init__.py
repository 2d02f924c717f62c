"""Measurement tools for the port, run on the GPU (`python -m rick_tpu_torch.tools.<name>`)."""
