"""The generator of burst traffic: a mix under ``traffic/`` whose
``generator`` is ``"bursts"`` is a JSON file of parameters that this
module reads.

A burst is made on the device from the seed, in a few large calls: a
broadband scene (multi-octave noise, blurred lightly; a torch copy of the
program's ``data/synthetic.py::_broadband_plane``), one per colour
channel; each frame the scene shifted uniformly within +-``max_shift_px``
and rotated uniformly within +-``max_rotation_deg`` about the centre
(frame 0 unmoved), cropped bilinearly (``_rotate_translate_crop``'s
formula); signal-dependent noise of variance alpha * x + beta, clipped to
[0, 1]; mosaicked under the configuration's CFA pattern where the entry
takes Bayer RAW. The same seed gives the same pool on the same device.

What the configuration decides (``needs``, from its adapter): ``layout``
("bayer" or "rgb"), ``cfa`` (2 x 2, 0 = R, 1 = G, 2 = B), and the noise's
``alpha`` and ``beta``.
"""

from __future__ import annotations

import math

import torch


def _uniform(gen: torch.Generator, n: int, bound: float, device) -> torch.Tensor:
    return (torch.rand(n, generator=gen, device=device, dtype=torch.float64) * 2.0 - 1.0) * bound


def broadband_planes(gen: torch.Generator, n: int, bh: int, bw: int, octaves, blur_passes: int,
                     device) -> torch.Tensor:
    """(n, bh, bw) float32 scenes in [0, 1]: per octave (size, amplitude)
    a standard normal grid of (bh // size + 2, bw // size + 2) repeated
    size x size, summed; then ``blur_passes`` of the [1/4, 1/2, 1/4]
    filter along each axis with zero padding; each plane scaled to its own
    min and max."""
    base = torch.zeros((n, bh, bw), dtype=torch.float32, device=device)
    for size, amp in octaves:
        size = int(size)
        noise = torch.randn((n, bh // size + 2, bw // size + 2), generator=gen, device=device,
                            dtype=torch.float32)
        up = noise.repeat_interleave(size, dim=1).repeat_interleave(size, dim=2)
        base += float(amp) * up[:, :bh, :bw]
    k = torch.tensor([0.25, 0.5, 0.25], dtype=torch.float32, device=device)
    for _ in range(int(blur_passes)):
        base = torch.nn.functional.conv2d(base[:, None], k.view(1, 1, 3, 1), padding=(1, 0))[:, 0]
        base = torch.nn.functional.conv2d(base[:, None], k.view(1, 1, 1, 3), padding=(0, 1))[:, 0]
    lo = base.amin(dim=(1, 2), keepdim=True)
    hi = base.amax(dim=(1, 2), keepdim=True)
    return (base - lo) / (hi - lo + 1e-8)


def rotate_translate_crop(scene: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor, angle: torch.Tensor,
                          out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear crops (F, C, out_h, out_w) of ``scene`` (C, h, w), frame f
    rotated by angle[f] (radians) about the scene's centre and shifted by
    (dy[f], dx[f])."""
    c, h, w = scene.shape
    dev = scene.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = (torch.arange(out_h, device=dev, dtype=torch.float32) - (out_h - 1) / 2.0)[None, :, None]
    xx = (torch.arange(out_w, device=dev, dtype=torch.float32) - (out_w - 1) / 2.0)[None, None, :]
    ca = torch.cos(angle).float()[:, None, None]
    sa = torch.sin(angle).float()[:, None, None]
    src_y = cy + sa * xx + ca * yy + dy.float()[:, None, None]
    src_x = cx + ca * xx - sa * yy + dx.float()[:, None, None]
    y0 = src_y.floor().long().clamp(0, h - 2)
    x0 = src_x.floor().long().clamp(0, w - 2)
    fy = (src_y - y0).clamp(0.0, 1.0)[:, None]
    fx = (src_x - x0).clamp(0.0, 1.0)[:, None]
    flat = scene.reshape(c, h * w)

    def at(yi, xi):  # (F, C, out_h, out_w)
        idx = (yi * w + xi).reshape(1, -1)
        return flat[:, idx[0]].reshape(c, *yi.shape).transpose(0, 1)

    return (at(y0, x0) * (1 - fy) * (1 - fx) + at(y0, x0 + 1) * (1 - fy) * fx
            + at(y0 + 1, x0) * fy * (1 - fx) + at(y0 + 1, x0 + 1) * fy * fx)


def mosaic(frames: torch.Tensor, cfa) -> torch.Tensor:
    """(F, 3, H, W) -> Bayer mosaic (F, H, W) under the 2 x 2 pattern
    ``cfa`` (0 = R, 1 = G, 2 = B)."""
    f, _, h, w = frames.shape
    out = torch.empty((f, h, w), dtype=frames.dtype, device=frames.device)
    for a in range(2):
        for b in range(2):
            out[:, a::2, b::2] = frames[:, int(cfa[a][b]), a::2, b::2]
    return out


def make_burst(gen: torch.Generator, mix: dict, needs: dict, device) -> torch.Tensor:
    """One burst of the mix from ``gen``: (F, H, W) Bayer RAW for layout
    "bayer", (F, H, W, 3) RGB for "rgb"; float32 in [0, 1]."""
    f, h, w = int(mix["frames"]), int(mix["height"]), int(mix["width"])
    alpha, beta = float(needs["alpha"]), float(needs["beta"])
    shift = float(mix["max_shift_px"])
    pad = int(math.ceil(shift)) + int(mix["pad_px"])
    scene = broadband_planes(gen, 3, h + 2 * pad, w + 2 * pad, mix["octaves"], mix["blur_passes"], device)
    dy, dx = _uniform(gen, f, shift, device), _uniform(gen, f, shift, device)
    angle = _uniform(gen, f, math.radians(float(mix["max_rotation_deg"])), device)
    dy[0] = dx[0] = angle[0] = 0.0
    frames = rotate_translate_crop(scene, dy, dx, angle, h, w)  # (F, 3, H, W)
    noise = torch.randn(frames.shape, generator=gen, device=device, dtype=torch.float32)
    frames = (frames + noise * (alpha * frames + beta).clamp_min(0.0).sqrt()).clamp(0.0, 1.0)
    if needs["layout"] == "bayer":
        return mosaic(frames, needs["cfa"]).contiguous()
    return frames.permute(0, 2, 3, 1).contiguous()


def make_pool(seed: int, mix: dict, needs: dict, device) -> list:
    """The mix's pool of ``pool`` distinct bursts, all from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return [make_burst(gen, mix, needs, device) for _ in range(int(mix["pool"]))]


def call_input(pool: list, i: int, mix: dict) -> torch.Tensor:
    """Call ``i``'s input: pool[i % len(pool)] scaled by
    1 - ``perturb`` * i, so that no two calls see equal data."""
    return pool[i % len(pool)] * (1.0 - float(mix["perturb"]) * i)
