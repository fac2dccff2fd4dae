"""Single-image DNN super-resolution CLI (counterpart of apps/dnn_sr.py),
the reference's cv::dnn_superres command-line surface
(test_opencv/main.cpp:569-591):

    python -m multi_frame_super_resolution_tpu_torch.apps.dnn_sr MODEL_PATH ALGO SCALE INPUT [OUTPUT] [--device DEV]
    python -m multi_frame_super_resolution_tpu_torch.apps.dnn_sr train MODEL_PATH ALGO SCALE [STEPS] [--device DEV]

  * MODEL_PATH: npz checkpoint of either package (readModel equivalent)
  * ALGO: espcn | fsrcnn | lapsrn | edsr (setModel equivalent)
  * SCALE: integer upsample factor
  * INPUT/OUTPUT: PNG paths (OUTPUT defaults to dnn_sr_result.png)

The ``train`` form fits the architecture on the JAX app's synthetic data
(12 batches of 8, LR 32 x 32, drawn from np.random.default_rng(0) as the
JAX app draws them, cycled) and writes a checkpoint both packages read.
Its initial parameters come from torch.Generator seed 0: flax's
lecun_normal distribution, with other values than the JAX app's.

Runs on cuda:0 unless ``--device`` (``main(device=...)``) names another
device, such as ``cpu``; with no card and no such request it raises.
"""

from __future__ import annotations

import sys


def _usage() -> int:
    print(__doc__)
    return 2


def train_data(scale: int, batches: int = 12, n: int = 8, size: int = 32):
    """The JAX app's training set: ``batches`` (lr (n, size, size, 3), hr
    (n, size*scale, size*scale, 3)) float32 numpy pairs, gray synthetic
    scenes repeated into RGB, LR by the bilinear resize, all drawn from
    one np.random.default_rng(0) in the JAX app's order."""
    import numpy as np
    import torch

    from multi_frame_super_resolution_tpu_torch.data import synthetic_burst
    from multi_frame_super_resolution_tpu_torch.ops.geometry import resize

    rng = np.random.default_rng(0)
    data = []
    for _ in range(batches):
        hrs, lrs = [], []
        for _ in range(n):
            g, _ = synthetic_burst(rng, num_frames=1, height=size * scale, width=size * scale, max_shift=0.0)
            hr = np.stack([g[0]] * 3, axis=-1)
            lrs.append(resize(torch.from_numpy(hr), size, size, "bilinear").numpy())
            hrs.append(hr)
        data.append((np.stack(lrs), np.stack(hrs)))
    return data


def _train(model_path: str, algo: str, scale: int, steps: int, device) -> int:
    import torch

    from multi_frame_super_resolution_tpu_torch import resolve_device
    from multi_frame_super_resolution_tpu_torch.models.dnn_sr import (
        create_sr_model,
        init_state,
        make_train_step,
        save_params,
    )

    dev = resolve_device(device, "dnn_sr train", "--device cpu (main(device='cpu'))")
    model = create_sr_model(algo, scale=scale)
    data = [tuple(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dev) for x in pair)
            for pair in train_data(scale)]
    state, opt = init_state(model, torch.Generator().manual_seed(0), data[0][0][:1])
    step = make_train_step(model, opt)
    for i in range(steps):
        lr, hr = data[i % len(data)]
        state, loss = step(state, lr, hr)
        if i % max(1, steps // 10) == 0:
            print(f"step {i}: loss {float(loss):.5f}")
    save_params(model_path, model.state_dict(), meta={"algo": algo, "scale": scale})
    print(f"saved {algo} x{scale} checkpoint to {model_path}")
    return 0


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" in argv[:-1]:
        at = argv.index("--device")
        device = argv[at + 1]
        del argv[at : at + 2]
    if argv and argv[0] == "train":
        if len(argv) < 4:
            return _usage()
        steps = int(argv[4]) if len(argv) > 4 else 200
        return _train(argv[1], argv[2], int(argv[3]), steps, device)
    if len(argv) < 4:
        return _usage()
    model_path, algo, scale_s, input_path = argv[:4]
    output_path = argv[4] if len(argv) > 4 else "dnn_sr_result.png"
    scale = int(scale_s)

    import torch

    from multi_frame_super_resolution_tpu_torch.data import imread, imwrite
    from multi_frame_super_resolution_tpu_torch.models.dnn_sr import create_sr_model, dnn_sr, load_params

    state_dict, meta = load_params(model_path)
    if meta.get("algo") and meta["algo"] != algo.lower():
        print(f"warning: checkpoint was trained as {meta['algo']!r}, requested {algo!r}")
    model = create_sr_model(algo, scale=scale)
    model.load_state_dict(state_dict)
    img = imread(input_path)
    out = dnn_sr(model, torch.from_numpy(img), device=device)
    imwrite(output_path, out.cpu().numpy())
    print(f"{algo} x{scale}: {img.shape} -> {tuple(out.shape)} -> {output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
