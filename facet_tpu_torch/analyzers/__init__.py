"""facet_tpu_torch.analyzers: counterparts of facet_tpu.analyzers."""
