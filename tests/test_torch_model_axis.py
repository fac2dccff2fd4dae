"""DNN SR's conv channels on the mesh's 'model' axis (models/dnn_sr.py,
parallel/mesh.py::model_rows) against the port's one-device step and
against the JAX package's jitted step and inference under
``jax.set_mesh``, on the CPU.

The port's positions are 2 or 4 on ``cpu``; JAX's mesh takes the 8
virtual CPU devices of tests/conftest.py. On a 'model' axis of m > 1,
each site's producer conv computes ceil(C / m)-channel blocks, one per
position (XLA's block rule: the last block short or empty), and the
blocks are gathered in order before the next conv, which sums every
channel in the unsharded order. The split changes no value beyond float32
summation order: the backward's input gradients are sums over the
blocks.
"""

import pathlib
import subprocess
import sys
import tomllib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch.utils._python_dispatch import TorchDispatchMode
from torch_parity import nn, tt

from multi_frame_super_resolution_tpu import parallel as jparallel
from multi_frame_super_resolution_tpu.models import dnn_sr as jdnn
from multi_frame_super_resolution_tpu_torch import parallel
from multi_frame_super_resolution_tpu_torch.apps import dnn_sr as app
from multi_frame_super_resolution_tpu_torch.models import dnn_sr
from multi_frame_super_resolution_tpu_torch.parallel import mesh as pmesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHECKPOINTS = ROOT / "multi_frame_super_resolution_tpu" / "data" / "checkpoints"
OUT_TOL = 1e-5  # tests/test_torch_dnn_sr.py's: max abs, outputs in [0, 1]
TRAIN_RTOL = 1e-6  # tests/test_torch_parallel.py's: float32 sums in another order
GRAD_RTOL = 1e-5  # chip_smoke.py's: two summation orders of ~1e4 terms, of the tensor's largest
# Adam (eps 1e-8) moves a parameter by m / (sqrt(v) + eps) lr: where the
# one-device gradient is at rounding level against its tensor's largest
# (measured: 3e-9 against 2e-2), or changes sign between steps so that
# the first moment nearly cancels, another summation order moves it by
# another share of a step. Such a parameter is held to 2 lr a step
# (tests/test_torch_dnn_sr.py::test_train_steps_match_jax's rule), and
# its gradients to GRAD_RTOL at every step. The data-parallel step
# without a 'model' axis needs the same rule for lapsrn x4 and edsr: on
# ('data',) (4,) the blanket 1e-6 rule fails there by 16x and 4x.
DECIDED_REL = 1e-4
LR = 1e-3  # init_state's Adam learning rate


def _cpu_mesh(sizes, axes=("data", "model")):
    return parallel.make_mesh(axes, sizes, ["cpu"] * int(np.prod(sizes)))


def _jax_mesh(sizes):
    return jparallel.make_mesh(("data", "model"), sizes, jax.devices()[: int(np.prod(sizes))])


def _nchw(x: np.ndarray) -> torch.Tensor:
    return tt(x).permute(0, 3, 1, 2)


class _Ops(TorchDispatchMode):
    """The aten ops a call runs, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


# ---- model_rows -------------------------------------------------------------

def test_model_rows_follow_the_axes():
    """Each 'data' position's row along 'model', whatever the axis order;
    one row without 'data', rows of one without 'model'."""
    devices = ["cpu", "cpu:0", "cpu:1", "cpu:2"]
    mesh = parallel.make_mesh(("data", "model"), (2, 2), devices)
    assert [[str(d) for d in row] for row in pmesh.model_rows(mesh)] == [["cpu", "cpu:0"], ["cpu:1", "cpu:2"]]
    mesh = parallel.make_mesh(("model", "data"), (2, 2), devices)
    assert [[str(d) for d in row] for row in pmesh.model_rows(mesh)] == [["cpu", "cpu:1"], ["cpu:0", "cpu:2"]]
    assert len(pmesh.model_rows(parallel.make_mesh(("model",), (4,), devices))) == 1
    assert [len(r) for r in pmesh.model_rows(parallel.make_mesh(("data",), (4,), devices))] == [1] * 4


# ---- (a) the split step against the one-device step ------------------------

FAMILIES = [("espcn", 2), ("fsrcnn", 2), ("lapsrn", 2), ("lapsrn", 4), ("edsr", 2)]


@pytest.mark.parametrize("sizes", [(2, 2), (1, 4)], ids=["data2_model2", "data1_model4"])
@pytest.mark.parametrize("algo,scale", FAMILIES, ids=[f"{a}_x{s}" for a, s in FAMILIES])
def test_split_train_step_matches_one_device(algo, scale, sizes):
    """Three Adam steps of each family at its default widths, batch 8 at
    LR 16 x 16, on 4 ``cpu`` positions with the channels split over
    'model', against the one-device step from the same parameters: the
    losses within 1e-6 relative, each step's summed gradients within
    1e-5 of their tensor's largest, the parameters within 1e-6 relative
    (of the tensor's largest) where the one-device gradient was at least
    1e-4 of its tensor's largest at every step and kept its sign, within
    2 lr a step elsewhere."""
    rng = np.random.default_rng(4)
    lr_b = torch.from_numpy(rng.random((8, 3, 16, 16)).astype(np.float32))
    hr_b = torch.from_numpy(rng.random((8, 3, 16 * scale, 16 * scale)).astype(np.float32))
    steps, models = [], []
    for mesh in (None, _cpu_mesh(sizes)):
        model = dnn_sr.create_sr_model(algo, scale)
        state, opt = dnn_sr.init_state(model, torch.Generator().manual_seed(0), lr_b[:1])
        steps.append((state, dnn_sr.make_train_step(model, opt, mesh=mesh)))
        models.append(model)
    decided = {k: torch.ones_like(p, dtype=torch.bool) for k, p in models[0].named_parameters()}
    signs = {k: torch.sign(torch.zeros_like(p)) for k, p in models[0].named_parameters()}
    for i in range(3):
        (s1, one), (s2, split) = steps
        _, want = one(s1, lr_b * (1 - 0.1 * i), hr_b)
        _, got = split(s2, lr_b * (1 - 0.1 * i), hr_b)
        torch.testing.assert_close(got, want, rtol=TRAIN_RTOL, atol=0)
        for (name, p), q in zip(models[1].named_parameters(), models[0].parameters()):
            largest = float(q.grad.abs().max())
            assert float((p.grad - q.grad).abs().max()) <= GRAD_RTOL * largest, (i, name)
            decided[name] &= q.grad.abs() >= DECIDED_REL * largest
            if i:
                decided[name] &= torch.sign(q.grad) == signs[name]
            signs[name] = torch.sign(q.grad)
    for (name, p), q in zip(models[1].named_parameters(), models[0].parameters()):
        p, q = p.detach(), q.detach()
        assert float((p - q).abs().max()) <= 2 * LR * 3, name
        torch.testing.assert_close(p[decided[name]], q[decided[name]], rtol=TRAIN_RTOL,
                                   atol=TRAIN_RTOL * float(q.abs().max()), msg=name)


def test_split_train_step_rejects_uneven_batch():
    model = dnn_sr.create_sr_model("espcn", 2, features=8)
    _, opt = dnn_sr.init_state(model, torch.Generator().manual_seed(0), torch.zeros(1, 3, 8, 8))
    step = dnn_sr.make_train_step(model, opt, mesh=_cpu_mesh((2, 2)))
    with pytest.raises(ValueError, match="equal shards"):
        step(None, torch.zeros(3, 3, 8, 8), torch.zeros(3, 3, 16, 16))


# ---- (b) the split step against JAX's on a 2 x 2 mesh ----------------------

@pytest.mark.parametrize("algo", ["espcn", "fsrcnn"])
def test_split_train_step_matches_jax_mesh(algo):
    """The port's step on (2, 2) ``cpu`` positions against JAX's jitted
    make_train_step under jax.set_mesh on a 2 x 2 ('data', 'model') mesh
    (the batch placed on 'data', the parameters replicated), from the same
    flax parameters, on the app's first three batches:
    tests/test_torch_dnn_sr.py::test_train_steps_match_jax's rule (losses
    rtol 1e-4; parameters within 1e-5 where every step's port gradient is
    at least 1e-4, within 2 lr a step everywhere)."""
    data = app.train_data(2, batches=3)
    jmodel = jdnn.create_sr_model(algo, 2)
    jstate, tx = jdnn.init_state(jmodel, jax.random.PRNGKey(0), jnp.asarray(data[0][0][:1]))
    model = dnn_sr.create_sr_model(algo, 2)
    state, opt = dnn_sr.init_state(model, torch.Generator().manual_seed(0), _nchw(data[0][0][:1]))
    model.load_state_dict(dnn_sr.params_from_flax(jstate.params))
    step = dnn_sr.make_train_step(model, opt, mesh=_cpu_mesh((2, 2)))
    jmesh = _jax_mesh((2, 2))
    decided = {k: torch.ones_like(p, dtype=torch.bool) for k, p in model.named_parameters()}
    with jax.set_mesh(jmesh):
        jstep = jax.jit(jdnn.make_train_step(jmodel, tx))
        batch = NamedSharding(jmesh, P("data"))
        for lr, hr in data:
            jlr, jhr = (jax.device_put(jnp.asarray(a), batch) for a in (lr, hr))
            jstate, jloss = jstep(jstate, jlr, jhr)
            state, loss = step(state, _nchw(lr), _nchw(hr))
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
            for k, p in model.named_parameters():
                decided[k] &= p.grad.abs() >= 1e-4
    want = dnn_sr.params_from_flax(jax.device_get(jstate.params))
    for k, p in state.params.items():
        diff = (p.detach() - want[k]).abs()
        assert diff.max() <= 2 * LR * len(data), k
        assert diff[decided[k]].max() <= 1e-5, k


# ---- (c) split inference against JAX's -------------------------------------

@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("algo", dnn_sr.SR_ALGORITHMS)
def test_split_inference_matches_jax_mesh(algo, m):
    """Each bundled x2 checkpoint through dnn_sr(mesh=) on (1, m) ``cpu``
    positions against JAX's jitted dnn_sr under jax.set_mesh on a (1, m)
    mesh, on a 24 x 40 x 3 image, within 1e-5 max abs."""
    img = np.random.default_rng(5).random((24, 40, 3)).astype(np.float32)
    path = str(CHECKPOINTS / f"{algo}_x2.npz")
    jparams, _ = jdnn.load_params(path)
    jmodel = jdnn.create_sr_model(algo, 2)
    with jax.set_mesh(_jax_mesh((1, m))):
        want = np.asarray(jax.jit(lambda p, x: jdnn.dnn_sr(jmodel, p, x))(jparams, jnp.asarray(img)))
    model = dnn_sr.create_sr_model(algo, 2)
    model.load_state_dict(dnn_sr.load_params(path)[0])
    got = dnn_sr.dnn_sr(model, tt(img), mesh=_cpu_mesh((1, m)))
    assert got.shape == (48, 80, 3) and got.device == torch.device("cpu")
    np.testing.assert_allclose(nn(got), want, rtol=0, atol=OUT_TOL)


def test_split_inference_refuses_data_axis_and_device():
    model = dnn_sr.create_sr_model("espcn", 2, features=8)
    img = torch.zeros(8, 8, 3)
    with pytest.raises(ValueError, match="'data' axis of 2"):
        dnn_sr.dnn_sr(model, img, mesh=_cpu_mesh((2, 2)))
    with pytest.raises(ValueError, match="not both"):
        dnn_sr.dnn_sr(model, img, device="cpu", mesh=_cpu_mesh((1, 2)))


# ---- (d) each position computes its block -----------------------------------

@pytest.mark.parametrize("features,sizes,blocks", [
    (16, (2, 2), [(8, 8), (4, 4)]),
    (6, (2, 2), [(3, 3), (2, 1)]),
    (6, (1, 4), [(2, 2, 2), (1, 1, 1)]),
], ids=["f16_data2_model2", "f6_data2_model2", "f6_data1_model4_empty"])
def test_split_convs_compute_blocks(monkeypatch, features, sizes, blocks):
    """ESPCN, batch 4 at LR 8 x 8: every conv the split forward runs,
    recorded as it runs. Per data shard, each site's producer runs once per
    'model' position with a nonempty block, at XLA's per-position shapes
    (features 16 on 2 x 2: 8 + 8 and 4 + 4 channels; features 6: 3 + 3
    and 2 + 1, the 3-channel site's block padded to 2 in XLA; on 4
    positions the empty block computes nothing), and the last conv once
    whole. No conv computes a whole site's channels."""
    model = dnn_sr.init_params(dnn_sr.create_sr_model("espcn", 2, features=features), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).random((4, 3, 8, 8)).astype(np.float32))
    shapes = []
    conv2d = torch.nn.functional.conv2d

    def recorded(*args, **kwargs):
        out = conv2d(*args, **kwargs)
        shapes.append(tuple(out.shape))
        return out

    want = dnn_sr._row_forward({torch.device("cpu"): model}, [torch.device("cpu")], x)
    monkeypatch.setattr(torch.nn.functional, "conv2d", recorded)
    rows = pmesh.model_rows(_cpu_mesh(sizes))
    shard = 4 // sizes[0]
    got = torch.cat([dnn_sr._row_forward({torch.device("cpu"): model}, row, x[i * shard : (i + 1) * shard])
                     for i, row in enumerate(rows)])
    per_shard = [(shard, c, 8, 8) for site in blocks for c in site] + [(shard, 12, 8, 8)]
    assert shapes == per_shard * sizes[0]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---- (e) no split ------------------------------------------------------------

@pytest.mark.parametrize("algo,scale", FAMILIES, ids=[f"{a}_x{s}" for a, s in FAMILIES])
def test_unsplit_meshes_run_todays_ops(algo, scale):
    """dnn_sr on meshes without a 'model' axis of m > 1 ((1, 1), 'data'
    alone, 'model' of 1) runs the one-device call's aten ops and gives its
    output bit for bit."""
    model = dnn_sr.init_params(dnn_sr.create_sr_model(algo, scale), torch.Generator().manual_seed(0))
    img = tt(np.random.default_rng(1).random((12, 16, 3)).astype(np.float32))
    runs = []
    for kw in ({"device": "cpu"}, {"mesh": _cpu_mesh((1, 1))}, {"mesh": _cpu_mesh((1,), ("data",))},
               {"mesh": _cpu_mesh((1,), ("model",))}):
        with _Ops() as ops:
            out = dnn_sr.dnn_sr(model, img, **kw)
        runs.append((ops.ops, out))
    for ops, out in runs[1:]:
        assert ops == runs[0][0]
        assert torch.equal(out, runs[0][1])


def test_unsplit_train_step_runs_data_parallel_ops():
    """The train step on ('data', 'model') (2, 1) runs the 'data'-only
    mesh's ops and gives its losses and parameters bit for bit."""
    rng = np.random.default_rng(3)
    lr_b = torch.from_numpy(rng.random((4, 3, 12, 12)).astype(np.float32))
    hr_b = torch.from_numpy(rng.random((4, 3, 24, 24)).astype(np.float32))
    runs = []
    for mesh in (_cpu_mesh((2,), ("data",)), _cpu_mesh((2, 1))):
        model = dnn_sr.create_sr_model("edsr", 2)
        state, opt = dnn_sr.init_state(model, torch.Generator().manual_seed(0), lr_b[:1])
        step = dnn_sr.make_train_step(model, opt, mesh=mesh)
        with _Ops() as ops:
            losses = [step(state, lr_b, hr_b)[1] for _ in range(2)]
        runs.append((ops.ops, losses, [p.detach().clone() for p in model.parameters()]))
    assert runs[1][0] == runs[0][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[1][1], runs[0][1]))
    assert all(torch.equal(a, b) for a, b in zip(runs[1][2], runs[0][2]))


# ---- the port's console scripts -----------------------------------------------

SCRIPTS = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
JAX_SCRIPTS = sorted(k for k, v in SCRIPTS.items() if v.startswith("multi_frame_super_resolution_tpu."))


def test_pyproject_names_five_port_scripts():
    assert len(JAX_SCRIPTS) == 5
    assert sorted(k for k in SCRIPTS if k.startswith("mfsr-torch-")) == sorted(
        "mfsr-torch-" + k[len("mfsr-"):] for k in JAX_SCRIPTS)


@pytest.mark.parametrize("name", JAX_SCRIPTS)
def test_port_script_twins_jax_script(name):
    """Each JAX script ``mfsr-<x>`` has a twin ``mfsr-torch-<x>`` naming the
    port's app of the same module, whose target imports in a fresh
    interpreter without jax or the JAX package to a callable ``main``."""
    twin = "mfsr-torch-" + name[len("mfsr-"):]
    module, func = SCRIPTS[twin].split(":")
    assert SCRIPTS[twin] == SCRIPTS[name].replace("multi_frame_super_resolution_tpu.",
                                                  "multi_frame_super_resolution_tpu_torch.", 1)
    code = (
        "import importlib, sys\n"
        f"target = getattr(importlib.import_module({module!r}), {func!r})\n"
        "assert callable(target)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'multi_frame_super_resolution_tpu'\n"
        "       or m.startswith('multi_frame_super_resolution_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=ROOT)
