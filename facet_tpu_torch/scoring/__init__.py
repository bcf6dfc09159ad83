"""facet_tpu_torch.scoring: counterparts of facet_tpu.scoring."""
