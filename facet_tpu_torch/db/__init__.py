"""Persistence: the port's copy of facet_tpu's SQLite layer (connection, schema, tags)."""
