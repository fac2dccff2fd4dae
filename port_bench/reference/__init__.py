"""The plain reference of the handheld entry points: plain PyTorch, importing
nothing of the program (``models/handheld.py`` is the entry)."""
