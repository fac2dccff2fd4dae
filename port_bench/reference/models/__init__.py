"""Part of the plain reference (see ``port_bench/reference/__init__.py``)."""
