"""facet_tpu_torch.processing: counterparts of facet_tpu.processing."""
