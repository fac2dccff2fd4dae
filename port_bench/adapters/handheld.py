"""The adapter of the handheld burst super-resolution configurations
(``configs/handheld_raw.json``, ``configs/handheld_rgb.json``): from a
configuration file and a traffic mix it builds the program's call, the
plain reference's, the control's, what the traffic generator needs and
the fields the per-layer readers take. A configuration file names its
adapter (``"adapter": "handheld"``); ``run.py`` reads none of the keys
below.

The keys it reads: ``entry`` and ``config_class`` (the program's entry
and configuration class, ``module:name``), ``reference`` and
``reference_config_class`` (the same of ``port_bench/reference``),
``layout`` ("bayer" or "rgb"), ``prebuild`` (the kernel modules whose
libraries the path launches) and ``handheld_config`` (every field of the
configuration but ``scale``, which the mix's ``zoom`` sets). The mix
gives ``frames``, ``height``, ``width`` and ``zoom``.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib


def import_attr(path: str):
    module, attr = path.split(":")
    return getattr(importlib.import_module(module), attr)


def build_config(cls, fields: dict):
    """An instance of the frozen dataclass ``cls`` from the dict
    ``fields``, nested dataclasses from nested dicts and lists as
    tuples; every field the dict leaves out keeps its default."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields:
            continue
        value = fields[f.name]
        default = cls.__dataclass_fields__[f.name].default
        if dataclasses.is_dataclass(default):
            value = build_config(type(default), value)
        elif isinstance(value, list):
            value = tuple(tuple(v) if isinstance(v, list) else v for v in value)
        kwargs[f.name] = value
    return cls(**kwargs)


class Subject:
    """One configuration under one mix on ``device``: calling it runs the
    program's entry on a burst; ``entry_wrap`` (faults, the control in
    the tests) wraps that entry."""

    def __init__(self, config: dict, mix: dict, device, entry_wrap=None):
        hc = config["handheld_config"]
        self.config, self.mix = config, mix
        self.scale = int(mix["zoom"])
        self.cfg = self.handheld_config(config["config_class"])
        self.ref_cfg = self.handheld_config(config["reference_config_class"])
        entry = functools.partial(import_attr(config["entry"]), device=device)
        self.entry = entry_wrap(entry) if entry_wrap is not None else entry
        self.needs = {"layout": config["layout"], "cfa": hc["cfa_pattern"],
                      "alpha": hc["robustness"]["alpha"], "beta": hc["robustness"]["beta"]}
        h, w = int(mix["height"]) * self.scale, int(mix["width"]) * self.scale
        self.output_shape = (h, w, 3)
        self.output_pixels = h * w

    def handheld_config(self, cls_path: str):
        cfg = build_config(import_attr(cls_path), self.config["handheld_config"])
        return dataclasses.replace(cfg, scale=self.scale)

    def prebuild(self) -> None:
        """Build, or load from ``build/kernels/``, the kernel libraries the
        configuration's path launches."""
        from multi_frame_super_resolution_tpu_torch.kernels import build

        build.build_all(importlib.import_module(f"multi_frame_super_resolution_tpu_torch.kernels.{k}").library
                        for k in self.config["prebuild"])

    def __call__(self, burst):
        return self.entry(burst, self.cfg)

    def reference(self, burst, hold=None):
        """The plain reference's output for ``burst``, matmuls with TF32
        off; ``hold`` (the control) rounds what each stage hands on."""
        import torch

        from port_bench.reference.models import handheld as ref

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with torch.no_grad():
            return import_attr(self.config["reference"])(burst, self.ref_cfg, hold=hold or ref.identity_hold)

    def control(self, burst):
        """The control: the reference with everything it hands from stage
        to stage held in bfloat16."""
        from port_bench.reference.models.handheld import bfloat16_hold

        return self.reference(burst, hold=bfloat16_hold)

    def reader_fields(self) -> dict:
        hc = self.config["handheld_config"]
        return dict(layout=self.config["layout"], merge=hc["merge"], scale=self.scale,
                    k_max=hc["merge"]["k_max"] * (self.scale / 2.0) ** 2, residual_bound=hc["residual_bound"],
                    frames=int(self.mix["frames"]), height=int(self.mix["height"]),
                    width=int(self.mix["width"]))


def subject(config: dict, mix: dict, device, entry_wrap=None) -> Subject:
    return Subject(config, mix, device, entry_wrap)


# the faults of a handheld cell, each a wrapper of the timed entry
def half_frames(entry):
    """Half of the burst's frames left out: the merge over the rest."""
    def call(burst, cfg):
        return entry(burst[: max(2, burst.shape[0] // 2)], cfg)
    return call


def answer_altered(entry):
    """An answer altered where it is produced: every value of the output
    raised by one 8-bit step (1/255), clipped to [0, 1]."""
    def call(burst, cfg):
        return (entry(burst, cfg) + 1.0 / 255.0).clamp(0.0, 1.0)
    return call


def tile_warp_off(share: float):
    """A kernel wrong on part of one tile row: the program's tile warp
    returns the middle row of tiles of every warped frame, over the middle
    ``share`` of its width (whole tiles, at least one), moved by one pixel
    along x, and is right everywhere else."""
    def wrap(entry):
        handheld = importlib.import_module("multi_frame_super_resolution_tpu_torch.models.handheld")

        def call(burst, cfg):
            sound = handheld.tile_warp

            def broken(planes, shifts, tile, *args, **kwargs):
                out = sound(planes, shifts, tile, *args, **kwargs).clone()
                top = (out.shape[-2] // tile // 2) * tile
                width = out.shape[-1]
                span = max(tile, int(width * share) // tile * tile)
                left = (width - span) // 2 // tile * tile
                band = out[..., top:top + tile, left:left + span]
                out[..., top:top + tile, left:left + span] = band.roll(1, dims=-1)
                return out

            handheld.tile_warp = broken
            try:
                return entry(burst, cfg)
            finally:
                handheld.tile_warp = sound
        return call
    return wrap


FAULTS = {"half_frames": half_frames, "answer_altered": answer_altered,
          "tile_row_warp": tile_warp_off(1.0), "tile_row_eighth_warp": tile_warp_off(0.125)}
