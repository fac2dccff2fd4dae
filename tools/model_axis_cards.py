"""DNN SR's 'model' axis over distinct cards: each family's train step
on a 'data'-only (n,) mesh and split on a ('data', 'model') (n / 2, 2)
mesh, and split inference of each bundled checkpoint at 1080 x 1920 ->
2160 x 3840 on (1, 2) and (1, n) meshes, over cuda:0 .. cuda:n-1, each
against the one-device form on cuda:0 by chip_smoke.py's rules
(``train_on_mesh``, ``split_inference``), with ms in in-call pairs and
device ops. A step that misses a rule is printed and the script goes on;
it exits 1 if any did.

Run on a host with n >= 2 cards (n even), from the root of the repo:
    python tools/model_axis_cards.py

chip_smoke.py runs the same checks with every position on cuda:0. The
times here are CUDA events on cuda:0, whose stream waits for the other
cards' blocks before the next conv; the train step's last parameter
copies to the other cards fall outside its last step's events.
"""

from __future__ import annotations

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    from multi_frame_super_resolution_tpu_torch.apps import dnn_sr as dnn_app
    from multi_frame_super_resolution_tpu_torch.models import dnn_sr
    from multi_frame_super_resolution_tpu_torch.parallel import make_mesh

    n = torch.cuda.device_count()
    if n < 2 or n % 2:
        print(f"model_axis_cards.py needs an even number of cards, 2 or more; this host has {n}")
        return 1
    t0 = time.perf_counter()
    card = chip_smoke.card_line()
    cards = [torch.device("cuda", i) for i in range(n)]
    print(card)
    data = [tuple(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(cards[0]) for x in pair)
            for pair in dnn_app.train_data(2, batches=3)]
    meshes = ((make_mesh(("data",), (n,), cards), f"data-parallel on ('data',) ({n},) over cuda:0-{n - 1}"),
              (make_mesh(("data", "model"), (n // 2, 2), cards),
               f"split on ('data', 'model') ({n // 2}, 2) over cuda:0-{n - 1}"))
    missed = []
    for algo in dnn_sr.SR_ALGORITHMS:
        for mesh, label in meshes:
            try:
                chip_smoke.train_on_mesh(algo, mesh, label, data, card)
            except RuntimeError as e:
                print(f"MISSED: {e}")
                missed.append(f"{algo} {label}")
    for m in sorted({2, n}):
        chip_smoke.split_inference(cards[:m], card)
    print(f"model_axis_cards.py ran {time.perf_counter() - t0:.1f} s; steps that missed a rule: {missed or 'none'}")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
