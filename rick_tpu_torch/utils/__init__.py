from rick_tpu_torch.utils.images import save_image_grid
from rick_tpu_torch.utils.logging import ProfilerHook, StatsLogger

__all__ = ["ProfilerHook", "StatsLogger", "save_image_grid"]
