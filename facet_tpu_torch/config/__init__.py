"""Scoring configuration: the port's copy of facet_tpu's config modules."""
