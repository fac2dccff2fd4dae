"""Pipelines and merge models (counterparts of multi_frame_super_resolution_tpu.models)."""
