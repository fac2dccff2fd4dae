"""Burst registration (counterparts of multi_frame_super_resolution_tpu.registration)."""
