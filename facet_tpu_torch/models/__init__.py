"""facet_tpu_torch.models: counterparts of facet_tpu.models."""
