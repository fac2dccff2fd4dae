"""Image operations (counterparts of multi_frame_super_resolution_tpu.ops)."""
