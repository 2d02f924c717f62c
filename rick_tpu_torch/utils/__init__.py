from rick_tpu_torch.utils.images import save_image_grid

__all__ = ["save_image_grid"]
