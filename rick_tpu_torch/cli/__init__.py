"""Command-line entry points of the port (`python -m rick_tpu_torch.cli.<name>`)."""
