"""facet_tpu_torch.utils: counterparts of facet_tpu.utils."""
