"""The port's single-image DNN SR (models/dnn_sr.py and apps/dnn_sr.py)
against the JAX package on the CPU, and the JAX package's own DNN SR
tests (tests/test_dnn_sr.py) on the port.

The convolutions are float32 in both packages (XLA on the CPU, PyTorch's
CPU convolutions here, cuDNN with TF32 off on the card); they sum in
other orders, so outputs are compared within 1e-5 max abs (measured:
2.4e-7 to 7.2e-7 on the bundled checkpoints).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, tt

from multi_frame_super_resolution_tpu.apps.dnn_sr import main as jax_app_main
from multi_frame_super_resolution_tpu.data import synthetic_burst as jax_synthetic_burst
from multi_frame_super_resolution_tpu.models import dnn_sr as jdnn
from multi_frame_super_resolution_tpu.ops.geometry import resize as jax_resize
from multi_frame_super_resolution_tpu_torch.apps import dnn_sr as app
from multi_frame_super_resolution_tpu_torch.data import imread, imwrite, synthetic_burst
from multi_frame_super_resolution_tpu_torch.models import dnn_sr
from multi_frame_super_resolution_tpu_torch.ops.geometry import resize
from multi_frame_super_resolution_tpu_torch.utils import psnr

CHECKPOINTS = pathlib.Path(__file__).resolve().parents[1] / "multi_frame_super_resolution_tpu" / "data" / "checkpoints"
OUT_TOL = 1e-5  # max abs, outputs in [0, 1]


def _checkpoint(algo: str) -> str:
    return str(CHECKPOINTS / f"{algo}_x2.npz")


def _port_model(algo: str, state_dict, scale: int = 2):
    model = dnn_sr.create_sr_model(algo, scale=scale)
    model.load_state_dict(state_dict)
    return model


def _nchw(x: np.ndarray) -> torch.Tensor:
    return tt(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("algo", dnn_sr.SR_ALGORITHMS)
def test_bundled_checkpoint_matches_jax(algo):
    """Each bundled x2 checkpoint through the port's dnn_sr (read by the
    port's load_params) against the JAX dnn_sr on a 24 x 40 x 3 image."""
    img = np.random.default_rng(5).random((24, 40, 3)).astype(np.float32)
    jparams, jmeta = jdnn.load_params(_checkpoint(algo))
    state_dict, meta = dnn_sr.load_params(_checkpoint(algo))
    assert meta == jmeta and meta["algo"] == algo
    want = np.asarray(jdnn.dnn_sr(jdnn.create_sr_model(algo, 2), jparams, jnp.asarray(img)))
    got = dnn_sr.dnn_sr(_port_model(algo, state_dict), tt(img), device="cpu")
    assert got.shape == (48, 80, 3) and got.device == torch.device("cpu")
    np.testing.assert_allclose(nn(got), want, rtol=0, atol=OUT_TOL)


@pytest.mark.parametrize(
    "algo,scale", [("espcn", 2), ("fsrcnn", 2), ("lapsrn", 2), ("edsr", 2), ("lapsrn", 4), ("edsr", 4)]
)
def test_modules_match_flax_apply(algo, scale):
    """Each architecture from flax-initialised parameters carried across
    (params_from_flax), on a batch of two 12 x 16 images: the module on
    NCHW against flax's apply on NHWC, unclipped."""
    x = np.random.default_rng(scale).random((2, 12, 16, 3)).astype(np.float32)
    jmodel = jdnn.create_sr_model(algo, scale)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    model = _port_model(algo, dnn_sr.params_from_flax(params), scale)
    with torch.no_grad():
        got = nn(model(_nchw(x)).permute(0, 2, 3, 1))
    assert got.shape == (2, 12 * scale, 16 * scale, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL)


@pytest.mark.parametrize("algo", ["fsrcnn", "edsr"])
def test_checkpoints_cross_packages(tmp_path, algo):
    """A checkpoint written by the port's save_params loads in the JAX
    load_params and gives the port's output; one written by the JAX
    save_params loads in the port and gives JAX's output. EDSR has
    Conv_0-10, which numpy lists out of order. The layouts round-trip
    exactly."""
    img = np.random.default_rng(2).random((10, 14, 3)).astype(np.float32)
    jmodel = jdnn.create_sr_model(algo, 2)
    jparams = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(img)[None])
    port_model = dnn_sr.init_params(dnn_sr.create_sr_model(algo, 2), torch.Generator().manual_seed(3))

    dnn_sr.save_params(str(tmp_path / "port.npz"), port_model.state_dict(), meta={"algo": algo, "scale": 2})
    loaded, meta = jdnn.load_params(str(tmp_path / "port.npz"))
    assert meta == {"algo": algo, "scale": "2"}
    want = nn(dnn_sr.dnn_sr(port_model, tt(img), device="cpu"))
    np.testing.assert_allclose(np.asarray(jdnn.dnn_sr(jmodel, loaded, jnp.asarray(img))), want, rtol=0, atol=OUT_TOL)

    jdnn.save_params(str(tmp_path / "jax.npz"), jparams, meta={"algo": algo, "scale": 2})
    state_dict, meta = dnn_sr.load_params(str(tmp_path / "jax.npz"))
    assert meta == {"algo": algo, "scale": "2"}
    got = nn(dnn_sr.dnn_sr(_port_model(algo, state_dict), tt(img), device="cpu"))
    np.testing.assert_allclose(got, np.asarray(jdnn.dnn_sr(jmodel, jparams, jnp.asarray(img))), rtol=0, atol=OUT_TOL)

    back = dnn_sr.params_to_flax(dnn_sr.params_from_flax(jparams))
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat) == sum(len(v) for v in back["params"].values())
    for path, leaf in flat:
        conv, kind = path[-2].key, path[-1].key
        np.testing.assert_array_equal(back["params"][conv][kind], np.asarray(leaf))


def test_app_training_data_equal_jax():
    """The train form's data: 12 batches of 8 (LR 32 x 32, HR 64 x 64)
    from np.random.default_rng(0), bit for bit the arrays the JAX app
    draws (the port's synthetic_burst and resize against the JAX
    package's)."""
    got = app.train_data(2)
    rng = np.random.default_rng(0)
    assert len(got) == 12
    for lr, hr in got:
        assert lr.shape == (8, 32, 32, 3) and hr.shape == (8, 64, 64, 3)
        for i in range(8):
            g, _ = jax_synthetic_burst(rng, num_frames=1, height=64, width=64, max_shift=0.0)
            want_hr = np.stack([g[0]] * 3, axis=-1)
            np.testing.assert_array_equal(hr[i], want_hr)
            np.testing.assert_array_equal(lr[i], np.asarray(jax_resize(jnp.asarray(want_hr), 32, 32, "bilinear")))


@pytest.mark.parametrize("algo", ["fsrcnn", "espcn"])
def test_train_steps_match_jax(algo):
    """Three Adam steps (init_state's optimizer, LR 1e-3) on the app's
    first three batches from the same flax-initialised parameters: the losses agree within rtol
    1e-4. Adam's first steps move a parameter by about lr * sign(g), so
    where |g| is at rounding level the two packages may move it in
    opposite directions: the parameters agree within 1e-5 where every
    step's port gradient is at least 1e-4 in magnitude, and everywhere
    within 2 lr per step (measured: within 6.5e-6 everywhere)."""
    data = app.train_data(2, batches=3)
    jmodel = jdnn.create_sr_model(algo, 2)
    jstate, tx = jdnn.init_state(jmodel, jax.random.PRNGKey(0), jnp.asarray(data[0][0][:1]))
    model = dnn_sr.create_sr_model(algo, 2)
    state, opt = dnn_sr.init_state(model, torch.Generator().manual_seed(0), _nchw(data[0][0][:1]))
    model.load_state_dict(dnn_sr.params_from_flax(jstate.params))  # in place: the optimizer keeps them
    jstep = jax.jit(jdnn.make_train_step(jmodel, tx))
    step = dnn_sr.make_train_step(model, opt)
    decided = {k: torch.ones_like(p, dtype=torch.bool) for k, p in model.named_parameters()}
    for lr, hr in data:
        jstate, jloss = jstep(jstate, jnp.asarray(lr), jnp.asarray(hr))
        state, loss = step(state, _nchw(lr), _nchw(hr))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        for k, p in model.named_parameters():
            decided[k] &= p.grad.abs() >= 1e-4
    want = dnn_sr.params_from_flax(jstate.params)
    for k, p in state.params.items():
        diff = (p.detach() - want[k]).abs()
        assert diff.max() <= 2 * 1e-3 * len(data), k
        assert diff[decided[k]].max() <= 1e-5, k


def test_init_params_is_lecun_normal():
    """init_params draws flax's lecun_normal (a normal truncated at +-2 of
    its stddevs, variance 1 / fan_in) and zero biases: over each model's
    kernels scaled by sqrt(fan_in), the stddev is within 5% of 1, as it is
    for flax's own init, and no value lies past the truncation."""
    img = jnp.zeros((1, 16, 16, 3), jnp.float32)
    for algo in dnn_sr.SR_ALGORITHMS:
        model = dnn_sr.init_params(dnn_sr.create_sr_model(algo, 2), torch.Generator().manual_seed(0))
        z = torch.cat([c.weight.detach().flatten() * np.sqrt(c.weight[0].numel()) for c in model.convs])
        assert abs(float(z.std()) - 1.0) <= 0.05, algo
        assert float(z.abs().max()) <= 2.0 / 0.87962566103423978 + 1e-5
        assert all(float(c.bias.detach().abs().max()) == 0.0 for c in model.convs)
        jz = np.concatenate([
            np.asarray(leaf["kernel"]).ravel() * np.sqrt(np.prod(np.asarray(leaf["kernel"]).shape[:3]))
            for leaf in jdnn.create_sr_model(algo, 2).init(jax.random.PRNGKey(0), img)["params"].values()
        ])
        assert abs(float(jz.std()) - 1.0) <= 0.05, algo


def test_dnn_sr_raises_without_card_unless_cpu_is_asked(monkeypatch):
    """No card and no device request: dnn_sr raises rather than run on the
    CPU, and names device="cpu"; with that request it runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = dnn_sr.create_sr_model("fsrcnn", 2)
    img = tt(np.random.default_rng(0).random((8, 8, 3)).astype(np.float32))
    with pytest.raises(RuntimeError, match='no CUDA device.*device="cpu"'):
        dnn_sr.dnn_sr(model, img)
    assert dnn_sr.dnn_sr(model, img, device="cpu").device == torch.device("cpu")


# tests/test_dnn_sr.py on the port


def test_espcn_shapes(rng):
    model = dnn_sr.create_model(scale=2, features=16)
    x = tt(rng.random((2, 3, 16, 16)).astype(np.float32))
    with torch.no_grad():
        assert model(x).shape == (2, 3, 32, 32)


def test_espcn_training_reduces_loss(rng):
    model = dnn_sr.create_model(scale=2, features=16)
    lr = tt(rng.random((4, 3, 12, 12)).astype(np.float32))
    hr = tt(rng.random((4, 3, 24, 24)).astype(np.float32))
    state, opt = dnn_sr.init_state(model, torch.Generator().manual_seed(0), lr[:1], learning_rate=1e-2)
    step = dnn_sr.make_train_step(model, opt)
    state, first = step(state, lr, hr)
    for _ in range(20):
        state, loss = step(state, lr, hr)
    assert float(loss) < float(first)


def test_dnn_sr_inference(rng):
    model = dnn_sr.init_params(dnn_sr.create_model(scale=3, features=8), torch.Generator().manual_seed(1))
    out = dnn_sr.dnn_sr(model, tt(rng.random((8, 8, 3)).astype(np.float32)), device="cpu")
    assert out.shape == (24, 24, 3)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


def test_sr_algorithm_factory_all_archs(rng):
    img = tt(rng.random((10, 12, 3)).astype(np.float32))
    for algo in dnn_sr.SR_ALGORITHMS:
        model = dnn_sr.init_params(dnn_sr.create_sr_model(algo, scale=2), torch.Generator().manual_seed(0))
        assert dnn_sr.dnn_sr(model, img, device="cpu").shape == (20, 24, 3), algo
    with pytest.raises(ValueError):
        dnn_sr.create_sr_model("bicubic++")


def test_checkpoint_roundtrip(tmp_path, rng):
    model = dnn_sr.init_params(dnn_sr.create_sr_model("fsrcnn", scale=2), torch.Generator().manual_seed(2))
    img = tt(rng.random((8, 8, 3)).astype(np.float32))
    path = str(tmp_path / "ck.npz")
    dnn_sr.save_params(path, model.state_dict(), meta={"algo": "fsrcnn", "scale": 2})
    state_dict, meta = dnn_sr.load_params(path)
    assert meta["algo"] == "fsrcnn"
    np.testing.assert_array_equal(
        nn(dnn_sr.dnn_sr(model, img, device="cpu")),
        nn(dnn_sr.dnn_sr(_port_model("fsrcnn", state_dict), img, device="cpu")),
    )


@pytest.mark.parametrize("algo", dnn_sr.SR_ALGORITHMS)
def test_bundled_checkpoint_beats_bilinear(rng, algo):
    """Every committed x2 checkpoint outperforms bilinear upsampling by
    0.5 dB on a held-out synthetic image (the weights are trained)."""
    state_dict, meta = dnn_sr.load_params(_checkpoint(algo))
    assert meta["algo"] == algo
    g, _ = synthetic_burst(rng, num_frames=1, height=64, width=64, max_shift=0.0)
    hr = tt(np.stack([g[0]] * 3, axis=-1))
    lr = resize(hr, 32, 32, "bilinear")
    pred = dnn_sr.dnn_sr(_port_model(algo, state_dict), lr, device="cpu")
    base = resize(lr, 64, 64, "bilinear").clamp(0, 1)
    p_model, p_base = float(psnr(hr, pred)), float(psnr(hr, base))
    assert p_model > p_base + 0.5, (algo, p_model, p_base)


@pytest.mark.parametrize("algo", dnn_sr.SR_ALGORITHMS)
def test_bundled_checkpoint_cli_inference(tmp_path, rng, algo):
    """The app's inference form against every bundled checkpoint writes
    the JAX app's image (the quantized outputs agree within one level)."""
    img = (rng.random((12, 16, 3)) * 255).astype(np.uint8)
    inp, outp, jaxp = (str(tmp_path / f) for f in ("in.png", "out.png", "jax.png"))
    imwrite(inp, img)
    assert app.main([_checkpoint(algo), algo, "2", inp, outp, "--device", "cpu"]) == 0
    assert jax_app_main([_checkpoint(algo), algo, "2", inp, jaxp]) == 0
    got = imread(outp)
    assert got.shape == (24, 32, 3)
    assert np.abs(got - imread(jaxp)).max() <= 1.0 / 255 + 1e-6


def test_dnn_sr_cli(tmp_path, rng, capsys):
    img = (rng.random((16, 20, 3)) * 255).astype(np.uint8)
    inp, outp, ck = (str(tmp_path / f) for f in ("in.png", "out.png", "ck.npz"))
    imwrite(inp, img)
    assert app.main(["train", ck, "fsrcnn", "2", "3"], device="cpu") == 0
    assert app.main([ck, "fsrcnn", "2", inp, outp], device="cpu") == 0
    assert imread(outp).shape == (32, 40, 3)
    out = capsys.readouterr().out
    assert "step 0: loss" in out and "saved fsrcnn x2 checkpoint" in out
    state_dict, _ = dnn_sr.load_params(ck)
    dnn_sr.save_params(ck, state_dict, meta={"algo": "other", "scale": 2})
    assert app.main([ck, "fsrcnn", "2", inp, outp], device="cpu") == 0
    assert "warning: checkpoint was trained as 'other'" in capsys.readouterr().out
    assert app.main([]) == 2
