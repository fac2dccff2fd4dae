"""Profiling utilities (counterpart of utils/profiling.py): a
``torch.profiler`` trace written for TensorBoard, and named ranges that
show in it (the port names its stages ``mfsr.*`` the same way)."""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the scope (host ops, and the card's where there is one) and
    write the trace under ``log_dir`` (view with TensorBoard or
    chrome://tracing)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """Named trace range:

        with annotate("align"):
            shifts = align_burst(gray)
    """
    return record_function(name)


def named(fn, name: str):
    """Wrap a function so each call shows under ``name`` in profiles."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return call
