"""The port's multi-device layer (parallel/mesh.py, runner.py,
spatial.py and the data-parallel DNN SR train step) against the JAX
package on the CPU.

The port's mesh is one process over a list of torch devices, which may
repeat: here 2 or 4 positions on ``cpu``, as the JAX tests run on the 8
virtual CPU devices of tests/conftest.py. Batched bursts equal single
calls bit for bit; the sharded pipelines agree with JAX's sharded
functions over the whole image at the pipelines' 60 dB limit (the edge
rule is the same), and their interiors with the port's unsharded runs at
JAX's 40 dB (tests/test_parallel.py). The JAX sharded and batched runs
jit for 10-40 s each; there are three.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, psnr, to_jax, tt

from multi_frame_super_resolution_tpu import parallel as jparallel
from multi_frame_super_resolution_tpu.models import handheld as jhandheld
from multi_frame_super_resolution_tpu.ops import filters as jfilters
from multi_frame_super_resolution_tpu.parallel import runner as jrunner
from multi_frame_super_resolution_tpu_torch import parallel
from multi_frame_super_resolution_tpu_torch.config import (
    RAW_BENCH,
    RAW_SCALE4,
    RGB_DEFAULT,
    AlignConfig,
    HandheldConfig,
    LKConfig,
)
from multi_frame_super_resolution_tpu_torch.data import mosaic_rggb, synthetic_burst
from multi_frame_super_resolution_tpu_torch.models import dnn_sr, handheld
from multi_frame_super_resolution_tpu_torch.ops.filters import gaussian_blur
from multi_frame_super_resolution_tpu_torch.parallel import mesh as pmesh
from multi_frame_super_resolution_tpu_torch.parallel import runner, spatial

PIPELINE_DB = 60.0  # the pipelines' limit against JAX (its LK paths' bf16 sums)
INTERIOR_DB = 40.0  # tests/test_parallel.py's interior limit, sharded against unsharded
BLUR_TOL = 1e-5  # tests/test_parallel.py::test_spatial_map_blur_parity's
TRAIN_RTOL = 1e-6  # data-parallel against one-device step: float32 sums in another order


def _cfg(tile=8, **kw):
    """tests/test_parallel.py's configuration (pre-alignment off unless
    ``kw`` sets it)."""
    return HandheldConfig(**{"align": AlignConfig(tile_size=tile, search_radius=2, levels=2),
                             "lk": LKConfig(half_window=4, iterations=1), "prealign": False, **kw})


def _cpu_mesh(n, axis="spatial"):
    return parallel.make_mesh((axis,), (n,), ["cpu"] * n)


def _rgb_burst(seed, frames, h, w, rotation=0.0):
    gray, _ = synthetic_burst(np.random.default_rng(seed), frames, h, w, 2.0, max_rotation=rotation)
    return np.stack([gray] * 3, axis=-1).astype(np.float32)


def _raw_burst(seed, frames, h, w, rotation=0.0):
    return np.stack([mosaic_rggb(f) for f in _rgb_burst(seed, frames, h, w, rotation)]).astype(np.float32)


def _jax_mesh(n):
    return jparallel.make_mesh(("spatial",), (n,), jax.devices()[:n])


def _jax_burst_rows(jmesh):
    """A burst's rows (axis 1) on JAX's 'spatial' axis."""
    return jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec(None, "spatial"))


# ---- mesh ----------------------------------------------------------------

def test_make_mesh_shapes_and_checks(monkeypatch):
    mesh = parallel.make_mesh(("data", "model"), (2, 2), ["cpu"] * 4)
    assert dict(mesh.shape) == {"data": 2, "model": 2} and mesh.size == 4
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert dict(parallel.make_mesh(("data", "model"), None, ["cpu"] * 3).shape) == {"data": 3, "model": 1}
    with pytest.raises(ValueError, match="needs 6 devices"):
        parallel.make_mesh(("data",), (6,), ["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh()  # no CPU default


@pytest.mark.parametrize("n,shape", [(4, (2, 2)), (3, (3, 1)), (1, (1, 1)), (6, (3, 2))])
def test_data_model_mesh_matches_jax(n, shape):
    """The model axis is 2 where the count is even, as in JAX."""
    got = parallel.data_model_mesh(n, devices=["cpu"] * 8)
    want = jparallel.data_model_mesh(n)
    assert tuple(got.shape.values()) == tuple(want.shape.values()) == shape
    assert got.axis_names == tuple(want.axis_names)


def test_default_mesh_needs_two_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert runner.default_mesh() is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = runner.default_mesh()
    assert list(mesh.devices.flat) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert mesh.axis_names == ("data",)


def test_shard_batch_gather_and_replicated():
    mesh = parallel.make_mesh(("data", "model"), (2, 2), ["cpu"] * 4)
    batch = torch.arange(24.0).reshape(4, 3, 2)
    shards = parallel.shard_batch(batch, mesh)
    assert [tuple(s.shape) for s in shards] == [(2, 3, 2)] * 2  # the 'data' positions
    assert torch.equal(pmesh.gather(shards), batch)
    copies = parallel.replicated(mesh).shard(batch)
    assert len(copies) == 4 and all(torch.equal(c, batch) for c in copies)
    with pytest.raises(ValueError, match="equal shards"):
        parallel.shard_batch(batch[:3], mesh)


# ---- batched bursts -------------------------------------------------------

@pytest.fixture(scope="module")
def bursts():
    """B = 2 bursts of 3 x 64 x 64 (RGB) and each one's single call."""
    cfg = _cfg()
    batch = np.stack([_rgb_burst(seed, 3, 64, 64) for seed in (0, 1)])
    singles = torch.stack([handheld.handheld_superres(tt(b), cfg, device="cpu") for b in batch])
    return cfg, batch, singles


@pytest.mark.parametrize("mode", ["scan", "vmap"])
@pytest.mark.parametrize("on_mesh", [False, True], ids=["no_mesh", "mesh2"])
def test_batched_pipeline_equals_single_calls(bursts, mode, on_mesh):
    """make_batched_pipeline in both modes, with and without a 2-position
    mesh (the batch a tensor, and on the mesh also the list of its shards):
    equal to the single-burst calls bit for bit."""
    cfg, batch, singles = bursts
    if on_mesh:
        mesh = _cpu_mesh(2, "data")
        fn = runner.make_batched_pipeline(functools.partial(handheld.handheld_superres, cfg=cfg), mesh, mode=mode)
        inputs = [tt(batch), parallel.shard_batch(tt(batch), mesh)]
    else:
        fn = runner.make_batched_pipeline(lambda b: handheld.handheld_superres(b, cfg, device="cpu"), mode=mode)
        inputs = [tt(batch)]
    for x in inputs:
        out = fn(x)
        assert out.shape == (2, 128, 128, 3)
        assert torch.equal(out, singles)


def test_batched_pipeline_rejects_unknown_mode_and_shards():
    with pytest.raises(ValueError, match="unknown mode"):
        runner.make_batched_pipeline(lambda b: b, mode="pmap")
    fn = runner.make_batched_pipeline(lambda b, device: b, _cpu_mesh(2, "data"))
    with pytest.raises(ValueError, match="3 shards"):
        fn([torch.zeros(1, 2)] * 3)


def test_batched_pipeline_matches_jax_scan(bursts):
    """The port's batch against JAX's make_batched_pipeline(mode="scan")
    on the same two bursts, each at the pipeline limit."""
    cfg, batch, singles = bursts
    jcfg = to_jax(cfg)
    want = jrunner.make_batched_pipeline(lambda b: jhandheld.handheld_superres(b, jcfg), mode="scan")(
        jnp.asarray(batch))
    got = runner.make_batched_pipeline(lambda b: handheld.handheld_superres(b, cfg, device="cpu"))(tt(batch))
    for i in range(2):
        p = psnr(nn(got[i]), np.asarray(want[i]))
        assert p > PIPELINE_DB, (i, p)


# ---- halo exchange and spatial_map ----------------------------------------

def test_exchange_halos_edge_rule():
    """Neighbours' rows inside, the block's own edge row repeated at the
    global border (JAX's rule, spatial.py:45-46), along any dimension."""
    x = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4 * 6, 2)
    blocks = list(x.chunk(4))
    halos = spatial._exchange_halos(blocks, 2)
    assert torch.equal(halos[0][0], x[:1].repeat(2, 1)) and torch.equal(halos[3][1], x[-1:].repeat(2, 1))
    for i in range(1, 4):
        assert torch.equal(halos[i][0], x[6 * i - 2 : 6 * i])
        assert torch.equal(halos[i - 1][1], x[6 * i : 6 * i + 2])
    cols = spatial._exchange_halos_axis([b.T.contiguous() for b in blocks], 2, dim=1)
    assert all(torch.equal(c[0], h[0].T) and torch.equal(c[1], h[1].T) for c, h in zip(cols, halos))
    with pytest.raises(ValueError, match="halo"):
        spatial._exchange_halos(blocks, 7)


@pytest.mark.parametrize("n", [4, 8])
def test_spatial_map_blur_matches_jax(n):
    """gaussian_blur(sigma 1, size 5) at halo 2 on n positions against
    JAX's spatial_map on its 8-device CPU mesh and the unsharded blur."""
    img = np.random.default_rng(0).random((64, 32)).astype(np.float32)
    blur = spatial.spatial_map(lambda x: gaussian_blur(x, 1.0, size=5), halo=2, mesh=_cpu_mesh(n))
    got = nn(blur(tt(img)))
    jmesh = _jax_mesh(8)
    jblur = jparallel.spatial_map(lambda x: jfilters.gaussian_blur(x, 1.0, size=5), halo=2, mesh=jmesh)
    want = np.asarray(jax.jit(jblur)(jax.device_put(jnp.asarray(img), jparallel.sharded_rows(jmesh))))
    np.testing.assert_allclose(got, want, rtol=0, atol=BLUR_TOL)
    np.testing.assert_allclose(got, nn(gaussian_blur(tt(img), 1.0, size=5)), rtol=0, atol=BLUR_TOL)


# ---- pipeline_halo ---------------------------------------------------------

@pytest.mark.parametrize("cfg,kw", [
    (RAW_BENCH, {}), (RGB_DEFAULT, {}), (RAW_SCALE4, {}), (RAW_BENCH, {"prealign_px": 8}),
    (RGB_DEFAULT, {"warp_bound": 8, "prealign_px": 3}), (_cfg(), {}), (HandheldConfig(scale=3), {}),
    (dataclasses.replace(RAW_BENCH, final_restore=False), {}),
], ids=["RAW_BENCH", "RGB_DEFAULT", "RAW_SCALE4", "RAW_BENCH_prealign_px8", "RGB_DEFAULT_bound8_px3",
        "test_parallel_cfg", "rgb_scale3", "no_restore"])
def test_pipeline_halo_matches_jax(cfg, kw):
    assert spatial.pipeline_halo(cfg, **kw) == jparallel.pipeline_halo(to_jax(cfg), **kw)


def test_raw_bench_halo_is_128_raw_rows():
    """chip_smoke.py's RAW shards: 2 * pipeline_halo(RAW_BENCH,
    prealign_px=8) RAW rows, within a 256-row shard."""
    assert 2 * parallel.pipeline_halo(RAW_BENCH, prealign_px=8) == 128


# ---- sharded pipelines -----------------------------------------------------

def _rgb_case(prealign):
    """tests/test_parallel.py's geometry: 4 shards, the halo the
    pipeline's (with 8 px for pre-alignment), 3 frames."""
    cfg = _cfg(prealign=prealign)
    halo = parallel.pipeline_halo(cfg, prealign_px=8 if prealign else 0)
    h = 4 * max(4 * cfg.align.tile_size, halo)
    return cfg, halo, _rgb_burst(0, 3, h, 96 if prealign else 64, 0.02 if prealign else 0.0)


def _raw_case(prealign):
    cfg = _cfg(gamma=False, prealign=prealign)
    halo = 2 * parallel.pipeline_halo(cfg, prealign_px=8 if prealign else 0)
    h = 4 * max(8 * cfg.align.tile_size, halo)
    return cfg, halo, _raw_burst(0, 3, h, 96 if prealign else 64, 0.02 if prealign else 0.0)


def test_rgb_sharded_matches_jax_sharded():
    """handheld_superres_sharded, pre-alignment off, against JAX's on the
    same burst over the whole image (the same edge rule)."""
    cfg, halo, burst = _rgb_case(False)
    got = nn(parallel.handheld_superres_sharded(tt(burst), cfg, _cpu_mesh(4), halo=halo))
    jmesh = _jax_mesh(4)
    want = jax.jit(lambda b: jparallel.handheld_superres_sharded(b, to_jax(cfg), jmesh, halo=halo))(
        jax.device_put(jnp.asarray(burst), _jax_burst_rows(jmesh)))
    assert got.shape == want.shape == (2 * burst.shape[1], 2 * burst.shape[2], 3)
    p = psnr(got, np.asarray(want))
    assert p > PIPELINE_DB, p


def test_raw_sharded_prealign_matches_jax_sharded():
    """handheld_superres_raw_sharded, pre-alignment on (one global
    estimate, half-res override origins), on a burst rotated within 0.02
    rad, against JAX's over the whole image."""
    cfg, halo, raw = _raw_case(True)
    got = nn(parallel.handheld_superres_raw_sharded(tt(raw), cfg, _cpu_mesh(4), halo=halo))
    jmesh = _jax_mesh(4)
    want = jax.jit(lambda b: jparallel.handheld_superres_raw_sharded(b, to_jax(cfg), jmesh, halo=halo))(
        jax.device_put(jnp.asarray(raw), _jax_burst_rows(jmesh)))
    assert got.shape == want.shape == (2 * raw.shape[1], 2 * raw.shape[2], 3)
    p = psnr(got, np.asarray(want))
    assert p > PIPELINE_DB, p


@pytest.mark.parametrize("path", ["rgb", "rgb_prealign", "raw", "raw_prealign"])
def test_sharded_interior_matches_unsharded(path):
    """Each sharded pipeline's interior (2 * halo output rows trimmed at
    both ends) against the port's unsharded run, above JAX's 40 dB."""
    raw = path.startswith("raw")
    cfg, halo, burst = (_raw_case if raw else _rgb_case)(path.endswith("prealign"))
    sharded = parallel.handheld_superres_raw_sharded if raw else parallel.handheld_superres_sharded
    entry = handheld.handheld_superres_raw if raw else handheld.handheld_superres
    out_sh = nn(sharded(tt(burst), cfg, _cpu_mesh(4), halo=halo))
    out_1 = nn(entry(tt(burst), cfg, device="cpu"))
    assert out_sh.shape == out_1.shape == (2 * burst.shape[1], 2 * burst.shape[2], 3)
    m = 2 * halo
    p = psnr(out_1[m:-m], out_sh[m:-m])
    assert p > INTERIOR_DB, p


@pytest.mark.parametrize("raw,h,halo", [(False, 4 * 12, None), (False, 4 * 16, 24), (False, 4 * 16 + 2, 16),
                                        (True, 4 * 24, None), (True, 4 * 32, 48), (False, 4 * 16, 32)],
                         ids=["rgb_rows", "rgb_halo", "rgb_uneven", "raw_rows", "raw_halo", "halo_over_shard"])
def test_sharded_rejects_misaligned_shards(raw, h, halo):
    """Shard heights and halos off the (2 x) tile grid, rows that do not
    split evenly, or a halo taller than a shard raise ValueError."""
    cfg = _cfg(gamma=False) if raw else _cfg()
    if raw:
        with pytest.raises(ValueError):
            parallel.handheld_superres_raw_sharded(torch.zeros(3, h, 64), cfg, _cpu_mesh(4), halo=halo)
    else:
        with pytest.raises(ValueError):
            parallel.handheld_superres_sharded(torch.zeros(3, h, 64, 3), cfg, _cpu_mesh(4), halo=halo)


# ---- data-parallel train step ----------------------------------------------

@pytest.mark.parametrize("devices,sizes,axes", [
    (["cpu"] * 2, (2,), ("data",)),
    (["cpu"] * 4, (4,), ("data",)),
    (["cpu"] * 4, (2, 2), ("data", "model")),
    (["cpu", "cpu:0"], (2,), ("data",)),
], ids=["data2", "data4", "data2_model2", "two_replicas"])
def test_data_parallel_train_step_matches_one_device(devices, sizes, axes):
    """ESPCN's step on a mesh against the one-device step from the same
    parameters, batch 8 at 16 x 16: losses and parameters after each of
    3 steps within 1e-6 relative (of the largest magnitude). "cpu" and
    "cpu:0" are two positions with a replica each (the same memory), so
    the replicas' gradient sum and parameter copy run here."""
    mesh = parallel.make_mesh(axes, sizes, devices)
    rng = np.random.default_rng(4)
    lr_b = torch.from_numpy(rng.random((8, 3, 16, 16)).astype(np.float32))
    hr_b = torch.from_numpy(rng.random((8, 3, 32, 32)).astype(np.float32))
    steps, models = [], []
    for m in (None, mesh):
        model = dnn_sr.create_model(2, features=16)
        state, opt = dnn_sr.init_state(model, torch.Generator().manual_seed(0), lr_b[:1])
        steps.append((state, dnn_sr.make_train_step(model, opt, mesh=m)))
        models.append(model)
    for i in range(3):
        (s1, one), (s2, dp) = steps
        _, want = one(s1, lr_b * (1 - 0.1 * i), hr_b)
        _, got = dp(s2, lr_b * (1 - 0.1 * i), hr_b)
        torch.testing.assert_close(got, want, rtol=TRAIN_RTOL, atol=0)
        for (name, p), q in zip(models[1].named_parameters(), models[0].parameters()):
            torch.testing.assert_close(p, q, rtol=TRAIN_RTOL, atol=TRAIN_RTOL * float(q.detach().abs().max()), msg=name)


def test_data_parallel_train_step_rejects_uneven_batch():
    model = dnn_sr.create_model(2, features=8)
    _, opt = dnn_sr.init_state(model, torch.Generator().manual_seed(0), torch.zeros(1, 3, 8, 8))
    step = dnn_sr.make_train_step(model, opt, mesh=_cpu_mesh(4, "data"))
    with pytest.raises(ValueError, match="equal shards"):
        step(None, torch.zeros(6, 3, 8, 8), torch.zeros(6, 3, 16, 16))
