"""Single-image DNN super-resolution (counterpart of models/dnn_sr.py):
the reference's cv::dnn_superres surface (main.cpp:569-591).

  * ``create_sr_model(algo, scale)``: espcn | fsrcnn | lapsrn | edsr, as
    ``torch.nn.Module``s taking NCHW, with the JAX package's widths
  * ``save_params`` / ``load_params``: npz checkpoints in the flax
    layout, so a checkpoint written by either package loads in the other
  * ``dnn_sr(model, img)``: inference on (H, W, C) in [0, 1]
  * ``init_state`` / ``make_train_step``: Adam on the mean squared error

Both entry points take a ``mesh`` (parallel/mesh.py): the batch splits
over its 'data' axis and, where its 'model' axis has m > 1 positions,
the conv channels that JAX constrains to ('data', -, -, 'model') split
over that axis (``_shard_channels``).

Each module keeps its convolutions in ``convs``, in the order flax
numbers them (``Conv_<i>`` is ``convs[i]``), and computes what the flax
module computes: the same pixel-shuffle channel order, (s, s, C), and
the JAX bilinear upsample (``ops.geometry.resize``). The convolutions run
on cuDNN on the card, in float32 with TF32 off: the JAX package computes
them in XLA (no Pallas kernel), and TF32 would compute another function.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses
import math
import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from multi_frame_super_resolution_tpu_torch import resolve_device
from multi_frame_super_resolution_tpu_torch.ops.geometry import resize


@contextlib.contextmanager
def float32_convs():
    """cuDNN convolutions in full float32 (TF32 off) for the scope; the
    other cuDNN settings stay as they are."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def _conv(c_in: int, c_out: int, k: int) -> nn.Conv2d:
    """flax's nn.Conv with padding "SAME" (its default too) at an odd size."""
    return nn.Conv2d(c_in, c_out, k, padding=k // 2)


_ROW: contextvars.ContextVar = contextvars.ContextVar("dnn_sr_model_row", default=None)


def _shard_channels(model: nn.Module, k: int, x: torch.Tensor) -> torch.Tensor:
    """relu(model.convs[k](x)), its channels on the mesh's 'model' axis: JAX's
    ``_shard_channels`` (dnn_sr.py:58-64) constrains that ReLU's output to
    ('data', -, -, 'model'), so its producer computes only its position's
    block of channels. Inside ``_row_forward`` on m > 1 positions, ``x``
    goes to each position's device, position j computes block j (XLA's
    ceil(C / m) channels, the last ones short or empty) with that device's
    replica, and the blocks are gathered in order on the first position,
    where the next conv reads every channel in the unsplit order.
    Elsewhere, as JAX's constraint does without a 'model' axis, unsplit."""
    row = _ROW.get()
    if row is None:
        return torch.relu(model.convs[k](x))
    devices, replicas = row
    # every copy of x first: a copy between cards waits for the work queued
    # before it on the source card, so copying inside the loop would hold
    # each position back until the previous position's conv is done
    inputs = {device: x.to(device) for device in devices}
    channels = model.convs[k].out_channels
    size = -(-channels // len(devices))
    blocks = []
    for j, device in enumerate(devices):
        lo, hi = min(j * size, channels), min((j + 1) * size, channels)
        if lo < hi:  # an empty block computes nothing
            conv = replicas[device].convs[k]
            block = F.conv2d(inputs[device], conv.weight[lo:hi], conv.bias[lo:hi], conv.stride, conv.padding)
            blocks.append(torch.relu(block).to(devices[0]))
    return torch.cat(blocks, 1)


def _row_forward(replicas: Dict[torch.device, nn.Module], devices: List[torch.device],
                 x: torch.Tensor) -> torch.Tensor:
    """The model on one data shard ``x`` (on ``devices[0]``) over its row
    of 'model' positions ``devices``: the sites' convolutions by blocks
    over the row, everything else on the first position's replica; with
    one position, that replica's forward."""
    if len(devices) == 1:
        return replicas[devices[0]](x)
    token = _ROW.set((devices, replicas))
    try:
        return replicas[devices[0]](x)
    finally:
        _ROW.reset(token)


def _replicas(model: nn.Module, mesh) -> Dict[torch.device, nn.Module]:
    """``model`` on its own device and a copy on each other device of ``mesh``."""
    replicas = {next(model.parameters()).device: model}
    for device in mesh.devices.flat:
        if device not in replicas:
            replicas[device] = copy.deepcopy(model).to(device)
    return replicas


def pixel_shuffle(h: torch.Tensor, scale: int, channels: int) -> torch.Tensor:
    """(B, s*s*C, H, W) -> (B, C, H*s, W*s) in flax's channel order:
    channel (i*s + j)*C + c goes to offset (i, j) of channel c
    (``nn.PixelShuffle`` reads (C, s, s))."""
    b, _, hh, ww = h.shape
    s = scale
    h = h.view(b, s, s, channels, hh, ww).permute(0, 3, 4, 1, 5, 2)
    return h.reshape(b, channels, hh * s, ww * s)


def upsample_bilinear(x: torch.Tensor, s: int) -> torch.Tensor:
    """x (B, C, H, W) -> (B, C, H*s, W*s) by ``jax.image.resize``'s
    bilinear, which ``ops.geometry.resize`` computes."""
    hwc = x.permute(0, 2, 3, 1)
    return resize(hwc, x.shape[2] * s, x.shape[3] * s, "bilinear").permute(0, 3, 1, 2)


class ESPCN(nn.Module):
    """Efficient sub-pixel CNN: features -> shrink -> scale^2*C channels ->
    pixel shuffle."""

    def __init__(self, scale: int = 2, channels: int = 3, features: int = 64):
        super().__init__()
        self.scale, self.channels = scale, channels
        self.convs = nn.ModuleList([
            _conv(channels, features, 5),
            _conv(features, features // 2, 3),
            _conv(features // 2, channels * scale * scale, 3),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _shard_channels(self, 0, x)
        h = _shard_channels(self, 1, h)
        return pixel_shuffle(self.convs[2](h), self.scale, self.channels)


class FSRCNN(nn.Module):
    """FSRCNN family: feature extraction -> shrink -> mapping -> expand ->
    sub-pixel upsample."""

    def __init__(self, scale: int = 2, channels: int = 3, d: int = 32, s_feat: int = 8, m: int = 2):
        super().__init__()
        self.scale, self.channels = scale, channels
        self.convs = nn.ModuleList([
            _conv(channels, d, 5),
            _conv(d, s_feat, 1),
            *(_conv(s_feat, s_feat, 3) for _ in range(m)),
            _conv(s_feat, d, 1),
            _conv(d, channels * scale * scale, 3),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _shard_channels(self, 0, x)
        for conv in self.convs[1:-2]:
            h = torch.relu(conv(h))
        h = _shard_channels(self, len(self.convs) - 2, h)
        return pixel_shuffle(self.convs[-1](h), self.scale, self.channels)


class LapSRN(nn.Module):
    """LapSRN family: progressive x2 stages, each predicting a Laplacian
    residual added to the bilinearly upsampled image. ``scale`` must be a
    power of two."""

    def __init__(self, scale: int = 2, channels: int = 3, features: int = 32, depth: int = 3):
        if scale < 2 or scale & (scale - 1):
            raise ValueError(f"lapsrn scale must be 2^k, got {scale}")
        super().__init__()
        self.features, self.depth = features, depth
        self.stages = scale.bit_length() - 1
        self.convs = nn.ModuleList([_conv(channels, features, 3)])
        for _ in range(self.stages):  # per x2 stage: depth convs, the shuffle's, the residual's
            self.convs.extend([*(_conv(features, features, 3) for _ in range(depth)),
                               _conv(features, features * 4, 3), _conv(features, channels, 3)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        img = x
        feat = torch.relu(self.convs[0](x))
        at = 1
        for _ in range(self.stages):
            for k in range(at, at + self.depth):
                feat = _shard_channels(self, k, feat)
            feat = pixel_shuffle(self.convs[at + self.depth](feat), 2, self.features)
            residual = self.convs[at + self.depth + 1](feat)
            img = upsample_bilinear(img, 2) + residual
            at += self.depth + 2
        return img


class EDSR(nn.Module):
    """EDSR family: residual blocks without batch norm + global skip,
    sub-pixel upsample, plus the bilinearly upsampled input."""

    def __init__(self, scale: int = 2, channels: int = 3, features: int = 32, blocks: int = 4):
        super().__init__()
        self.scale, self.channels, self.blocks = scale, channels, blocks
        self.convs = nn.ModuleList([
            _conv(channels, features, 3),
            *(_conv(features, features, 3) for _ in range(2 * blocks + 1)),
            _conv(features, channels * scale * scale, 3),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        head = self.convs[0](x)
        h = head
        for b in range(self.blocks):
            r = _shard_channels(self, 1 + 2 * b, h)
            r = self.convs[2 + 2 * b](r)
            h = h + 0.1 * r
        h = self.convs[-2](h) + head
        h = self.convs[-1](h)
        return pixel_shuffle(h, self.scale, self.channels) + upsample_bilinear(x, self.scale)


SR_ALGORITHMS = ("espcn", "fsrcnn", "lapsrn", "edsr")


def create_sr_model(algo: str, scale: int = 2, channels: int = 3, **kw) -> nn.Module:
    """Algorithm selector mirroring cv::dnn_superres setModel(algo, scale)
    (main.cpp:582-584). Unknown names raise ValueError. The parameters are
    torch's default initialisation until ``init_params``, ``init_state``
    or ``load_state_dict`` sets them."""
    classes = {"espcn": ESPCN, "fsrcnn": FSRCNN, "lapsrn": LapSRN, "edsr": EDSR}
    algo = algo.lower()
    if algo not in classes:
        raise ValueError(f"unknown SR algorithm {algo!r}; choose from {SR_ALGORITHMS}")
    return classes[algo](scale=scale, channels=channels, **kw)


def create_model(scale: int = 2, channels: int = 3, features: int = 64) -> ESPCN:
    return ESPCN(scale=scale, channels=channels, features=features)


_FLAX_KEY = re.compile(r"^params/Conv_(\d+)/(kernel|bias)$")


def params_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax params ({"params": {"Conv_<i>": {"kernel": HWIO, "bias"}}}, any
    arrays) -> a state dict of the port's modules (``convs.<i>.weight``
    OIHW, ``convs.<i>.bias``)."""
    out = {}
    for name, leaves in params["params"].items():
        i = int(name.split("_")[1])
        kernel = torch.from_numpy(np.array(leaves["kernel"], np.float32))
        out[f"convs.{i}.weight"] = kernel.permute(3, 2, 0, 1).contiguous()
        out[f"convs.{i}.bias"] = torch.from_numpy(np.array(leaves["bias"], np.float32))
    return out


def params_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``params_from_flax``: numpy arrays, HWIO kernels."""
    convs: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in state_dict.items():
        _, i, kind = key.split(".")
        arr = value.detach().cpu().numpy()
        leaf = convs.setdefault(f"Conv_{int(i)}", {})
        if kind == "weight":
            leaf["kernel"] = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        else:
            leaf["bias"] = arr
    return {"params": convs}


def save_params(path: str, state_dict: Dict[str, torch.Tensor], meta: dict | None = None) -> None:
    """Write a module's state dict as the JAX package's npz checkpoint:
    keys ``params/Conv_<i>/kernel`` (HWIO) and ``params/Conv_<i>/bias``,
    and the ``meta`` strings under ``__meta_<key>``."""
    flat = {
        f"params/{name}/{kind}": arr
        for name, leaves in params_to_flax(state_dict)["params"].items()
        for kind, arr in leaves.items()
    }
    for k, v in (meta or {}).items():
        flat[f"__meta_{k}"] = np.asarray(str(v))
    np.savez(path, **flat)


def load_params(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """Read an npz checkpoint of either package. Returns (state dict on
    the CPU, meta). Convolutions are found by the index in their key,
    never by file order (numpy lists Conv_10 before Conv_2)."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    meta: Dict[str, str] = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            if key.startswith("__meta_"):
                meta[key[len("__meta_"):]] = str(data[key])
                continue
            match = _FLAX_KEY.match(key)
            if match is None:
                raise ValueError(f"{path}: unexpected checkpoint key {key!r}")
            params.setdefault(f"Conv_{match.group(1)}", {})[match.group(2)] = data[key]
    return params_from_flax({"params": params}), meta


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default initialisation, drawn from ``generator`` (a CPU
    generator) conv by conv: lecun_normal kernels, a normal of stddev
    sqrt(1 / fan_in) / 0.87962566 truncated at +-2 of its stddevs, which
    has variance 1 / fan_in; zero biases. The distribution is flax's; the
    values are torch's draws, not flax's. The parameters are made on the
    CPU and copied to the model's device."""
    with torch.no_grad():
        for conv in model.convs:
            fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(conv.weight.shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            conv.weight.copy_(w)
            conv.bias.zero_()
    return model


@dataclasses.dataclass
class TrainState:
    """The model's parameters and the optimizer's state: live references,
    which the train step updates in place (PyTorch's optimizers own their
    state)."""

    params: Dict[str, torch.Tensor]
    opt_state: Any


def init_state(
    model: nn.Module, generator: torch.Generator, sample: torch.Tensor, learning_rate: float = 1e-3
) -> Tuple[TrainState, torch.optim.Optimizer]:
    """Initialise ``model`` from ``generator`` (``init_params``) on the
    device of ``sample`` (a batch, NCHW) and make its optimizer:
    ``torch.optim.Adam`` with optax.adam's defaults (betas 0.9 and 0.999,
    eps 1e-8 added to the root of the second moment's estimate)."""
    init_params(model, generator).to(sample.device)
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(params=dict(model.named_parameters()), opt_state=opt.state), opt


def loss_fn(model: nn.Module, lr_batch: torch.Tensor, hr_batch: torch.Tensor) -> torch.Tensor:
    pred = model(lr_batch)
    return torch.mean((pred - hr_batch) ** 2)


def make_train_step(model: nn.Module, opt: torch.optim.Optimizer, mesh=None):
    """(state, lr, hr) -> (state, loss): one Adam step on the mean squared
    error of ``model(lr)`` (NCHW batches) against ``hr``, its convolutions
    in float32 with TF32 off. The gradients come from autograd. The state
    returned is ``state``, whose tensors the step updated in place.

    With a ``mesh`` (parallel/mesh.py), the step that JAX's jit over
    inputs sharded on 'data' computes, with the activations constrained to
    ('data', -, -, 'model'): the batch splits over the 'data' positions (a
    batch that does not divide raises ValueError), and each shard's
    forward spans its row of 'model' positions (``_row_forward``: where
    the 'model' axis has m > 1 positions, each site's conv by channel
    blocks over the row). Each data shard's loss is its squared-error sum
    over the whole batch's element count; autograd puts the gradients in
    each device's replica (a site conv's in disjoint blocks), and their
    sum onto ``model`` (the replica on its own device) is the full
    batch's mean's. Adam steps there and the parameters are copied to the
    replicas on the mesh's other devices, so they stay replicated;
    positions that share a device share that device's replica."""
    if mesh is None:
        def train_step(state: TrainState, lr_batch: torch.Tensor, hr_batch: torch.Tensor):
            with float32_convs():
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(model, lr_batch, hr_batch)
                loss.backward()
                opt.step()
            return state, loss.detach()

        return train_step

    from multi_frame_super_resolution_tpu_torch.parallel.mesh import Sharding, model_rows

    home = next(model.parameters()).device
    sharding = Sharding(mesh, "data")
    rows = model_rows(mesh)
    replicas = _replicas(model, mesh)
    others = [replica for replica in replicas.values() if replica is not model]

    def train_step(state: TrainState, lr_batch: torch.Tensor, hr_batch: torch.Tensor):
        with float32_convs():
            for replica in replicas.values():
                replica.zero_grad(set_to_none=True)
            count = hr_batch.numel()
            losses = []
            for lr_shard, hr_shard, row in zip(sharding.shard(lr_batch), sharding.shard(hr_batch), rows):
                loss = torch.sum((_row_forward(replicas, row, lr_shard) - hr_shard) ** 2) / count
                loss.backward()
                losses.append(loss.detach().to(home))
            with torch.no_grad():
                for replica in others:
                    for p, q in zip(model.parameters(), replica.parameters()):
                        if q.grad is not None:
                            p.grad = q.grad.to(home) if p.grad is None else p.grad + q.grad.to(home)
            opt.step()
            with torch.no_grad():
                for replica in others:
                    for p, q in zip(model.parameters(), replica.parameters()):
                        q.copy_(p)
        return state, torch.stack(losses).sum()

    return train_step


def dnn_sr(model: nn.Module, img: torch.Tensor, device=None, mesh=None) -> torch.Tensor:
    """Single-image SR inference on ``img`` (H, W, C) in [0, 1] -> the
    clipped (sH, sW, C). Runs on cuda:0 unless ``device`` names another
    device (``resolve_device``: without a card it raises unless the CPU is
    asked for); the model is moved there.

    With a ``mesh`` instead of a ``device`` (its 'data' axis of 1, e.g.
    ``make_mesh(("data", "model"), (1, m), devices)``): JAX's ``dnn_sr``
    under ``jax.set_mesh``. The model moves to the mesh's first device,
    with a copy on each of its other devices, and the image's forward
    spans the 'model' positions as the train step's shards do; the output
    lies on the first device."""
    if mesh is None:
        dev = resolve_device(device, "dnn_sr", 'device="cpu"')
        model.to(dev)
        x = img.to(dev, torch.float32).permute(2, 0, 1)[None]
        with torch.no_grad(), float32_convs():
            out = model(x)
        return out[0].permute(1, 2, 0).clamp(0.0, 1.0)

    from multi_frame_super_resolution_tpu_torch.parallel.mesh import model_rows

    if device is not None:
        raise ValueError("dnn_sr takes a device or a mesh, not both")
    rows = model_rows(mesh)
    if len(rows) != 1:
        raise ValueError(f"dnn_sr's one image does not split over a 'data' axis of {len(rows)}")
    model.to(rows[0][0])
    x = img.to(rows[0][0], torch.float32).permute(2, 0, 1)[None]
    with torch.no_grad(), float32_convs():
        out = _row_forward(_replicas(model, mesh), rows[0], x)
    return out[0].permute(1, 2, 0).clamp(0.0, 1.0)
