"""Top-k selection and masked reductions (counterparts of ops/reduce.py),
on the device of their inputs with no host round trip.

``lax.top_k`` orders equal values by their flat index, lowest first, and
so selects the lowest indices among the values tied at the k-th rank.
``torch.topk`` makes no such promise, and a 25 x 25 erode leaves wide
plateaus of equal values in a dark channel, where the airlight sums
depend on which tied pixels are taken. ``top_k_indices`` therefore takes
the first k of a stable descending sort: the indices ``lax.top_k``
returns, in its order.
"""

from __future__ import annotations

import torch


def top_k_indices(values: torch.Tensor, k: int) -> torch.Tensor:
    """Flat indices of the k largest entries of ``values``, largest first
    and ties in index order (the indices of ``lax.top_k``)."""
    return torch.sort(values.reshape(-1), descending=True, stable=True).indices[:k]


def top_k_mask(values: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask (shape of ``values``) of the entries >= the k-th
    largest: more than k where values tie at the k-th rank."""
    kth = torch.topk(values.reshape(-1), k).values[-1]
    return values >= kth


def masked_channel_sums(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-channel sums of img (H, W, C) over mask (H, W)."""
    return (img * mask[..., None]).sum(dim=(0, 1))


def top_k_channel_means(img: torch.Tensor, scores: torch.Tensor, k: int) -> torch.Tensor:
    """Mean of img (H, W, C) over the k pixels with the highest ``scores``
    (H, W), exactly k, ties taken as ``top_k_indices`` takes them."""
    h, w = scores.shape
    return img.reshape(h * w, -1)[top_k_indices(scores, k)].mean(dim=0)
