"""Dtypes, logging, preferences (reference: newsched_tpu/utils)."""
