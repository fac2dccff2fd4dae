"""The benchmark of the PyTorch / CUDA port of handheld burst super-resolution
(``multi_frame_super_resolution_tpu_torch``): see ``run.py``."""
