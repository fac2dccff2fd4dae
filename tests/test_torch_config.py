"""The port's own configuration against the JAX package's: the same
dataclasses, field for field, and to_jax rebuilding one from the other."""

import dataclasses

import pytest
from torch_parity import to_jax

from multi_frame_super_resolution_tpu import config as jax_config
from multi_frame_super_resolution_tpu_torch import config

COPIED = [
    "AlignConfig", "LKConfig", "RobustnessConfig", "MergeConfig", "RegistrationConfig",
    "PREALIGN_FAST", "HandheldConfig", "DarkChannelConfig", "PolarDefogConfig", "BTVConfig",
    "FlowConfig",
]


@pytest.mark.parametrize("name", COPIED)
def test_copied_config_matches_jax(name):
    """Same field names in the same order, and the port's default (or
    the constant) rebuilt as the JAX one equals the JAX one."""
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    if isinstance(theirs, type):
        ours, theirs = ours(), theirs()
    assert type(ours) is not type(theirs)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    assert to_jax(ours) == theirs
    assert type(to_jax(ours)) is type(theirs)


def test_raw_bench_is_bench_py_configuration():
    """bench.py times HandheldConfig(align=AlignConfig(tile_size=16,
    search_radius=4, levels=2), gamma=False)."""
    want = jax_config.HandheldConfig(
        align=jax_config.AlignConfig(tile_size=16, search_radius=4, levels=2), gamma=False
    )
    assert to_jax(config.RAW_BENCH) == want


def test_to_jax_keeps_every_field():
    """A config with every nested field off its default comes back with
    each value in place."""
    cfg = dataclasses.replace(
        config.RAW_BENCH,
        merge=config.MergeConfig(k_detail=0.5, rgb_order=None, centroid_prune=1.0),
        lk=config.LKConfig(bf16=False),
        prealign_cfg=config.RegistrationConfig(downsample=2),
        cfa_pattern=((2, 1), (1, 0)),
    )
    got = to_jax(cfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(cfg)
    assert isinstance(got.merge, jax_config.MergeConfig)
    assert isinstance(got.prealign_cfg, jax_config.RegistrationConfig)
