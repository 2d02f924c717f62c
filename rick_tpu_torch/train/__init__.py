from rick_tpu_torch.train.steps import sample_images

__all__ = ["sample_images"]
