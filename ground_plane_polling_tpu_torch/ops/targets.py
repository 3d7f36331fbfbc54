"""Anchor target assignment on the device (port of
ground_plane_polling_tpu/ops/targets.py), written over a batch axis.

  * every anchor takes its arg-max-IoU annotation (the first on ties; masked
    columns count as IoU -1); IoU < 0.4 => negative, >= 0.5 => positive,
    in between => ignore (-1);
  * a positive lights one class-orientation slot `4 * class + orient` of an
    (A, 4C) grid, duplicated into two sign halves gated by the side of the
    anchor centre on which the ground-truth xm keypoint falls (0.5 in both
    halves when xm is exactly on the centre);
  * regression targets are computed for every anchor against its assigned
    annotation (the losses mask them by the state column);
  * an anchor whose centre lies in an ignore region (inclusive edges) gets
    state -1;
  * with no annotations every anchor takes the zero row 0, and its targets
    are encode(anchor, 0).

Padding contract: `annotations` (B, G, 17) with `ann_mask` marking real rows,
pad rows zero; `ignore_regions` (B, M, 4) with `ignore_mask`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import box_coder
from .overlap import iou_matrix

__all__ = ["anchor_targets", "batched_anchor_targets"]


def batched_anchor_targets(anchors, annotations, ann_mask, ignore_regions,
                           ignore_mask, num_classes: int = 1,
                           negative_overlap: float = 0.4,
                           positive_overlap: float = 0.5):
    """Training targets for a batch; `anchors` (A, 4) are shared.

    Returns dict with
      labels:         (B, A, 8C) classification targets (-1 / 0 / 1, and 0.5
                      in both sign halves for an on-centre xm);
      regression:     (B, A, 13) 12 encoded box+keypoint targets + state;
      regression_dim: (B, A*C, 4) per-class (h, w, l) targets + state.
    """
    b, n, c = annotations.shape[0], anchors.shape[0], num_classes
    dtype = anchors.dtype

    # --- IoU assignment ------------------------------------------------
    overlaps = iou_matrix(anchors, annotations[..., :4])       # (B, A, G)
    overlaps = torch.where(ann_mask[:, None, :], overlaps,
                           torch.full_like(overlaps, -1.0))
    argmax = overlaps.argmax(dim=2)                            # first max
    max_overlaps = overlaps.gather(2, argmax[..., None])[..., 0]
    assigned = annotations.gather(
        1, argmax[..., None].expand(b, n, annotations.shape[2]))  # (B, A, 17)
    positive = (max_overlaps >= positive_overlap)[..., None]
    negative = (max_overlaps < negative_overlap)[..., None]
    cls = assigned[..., 15].to(torch.int32)
    orient = assigned[..., 16].to(torch.int32)

    # --- class-orientation labels (B, A, 4C); out-of-range slots one-hot
    # to all zeros, as the JAX package's one_hot does
    neg_or_ignore = torch.where(negative, 0.0, -1.0).to(dtype)
    slot = (4 * cls + orient)[..., None]
    onehot4c = (slot == torch.arange(4 * c, device=slot.device)).to(dtype)
    labels4c = torch.where(positive, onehot4c, neg_or_ignore)
    onehot_dim = (cls[..., None] == torch.arange(c, device=cls.device)).to(
        dtype)
    labels_dim = torch.where(positive, onehot_dim, neg_or_ignore)

    # --- ignore regions: anchor centre inside any region ---------------
    cx = ((anchors[:, 0] + anchors[:, 2]) / 2.0)[None, :, None]
    cy = ((anchors[:, 1] + anchors[:, 3]) / 2.0)[None, :, None]
    reg = ignore_regions[:, None, :, :]                        # (B, 1, M, 4)
    inside = ((cx >= reg[..., 0]) & (cy >= reg[..., 1])
              & (cx <= reg[..., 2]) & (cy <= reg[..., 3])
              & ignore_mask[:, None, :])
    ignored = inside.any(dim=2, keepdim=True)                  # (B, A, 1)
    labels4c = torch.where(ignored, -1.0, labels4c)
    labels_dim = torch.where(ignored, -1.0, labels_dim)

    # --- regression targets + sign-duplicated labels -------------------
    targets12, sign01 = box_coder.encode_boxes(anchors, assigned[..., :12])
    state = labels4c.amax(dim=2, keepdim=True)                 # (B, A, 1)
    labels8c = torch.cat([labels4c * (1.0 - sign01)[..., None],
                          labels4c * sign01[..., None]], dim=2)
    labels8c = torch.where(state == -1.0, -1.0, labels8c)
    regression = torch.cat([targets12, state], dim=2)

    # --- dimension targets, tiled per class ----------------------------
    dims = box_coder.encode_dims(assigned[..., 12:15].repeat(1, 1, c),
                                 np.tile(box_coder.DIM_MEAN, c),
                                 np.tile(box_coder.DIM_STD, c))
    regression_dim = torch.cat([dims.reshape(b, n * c, 3),
                                labels_dim.reshape(b, n * c, 1)], dim=2)
    return {"labels": labels8c, "regression": regression,
            "regression_dim": regression_dim}


def anchor_targets(anchors, annotations, ann_mask, ignore_regions,
                   ignore_mask, num_classes: int = 1, **kw):
    """`batched_anchor_targets` for one image (no batch axis)."""
    out = batched_anchor_targets(anchors, annotations[None], ann_mask[None],
                                 ignore_regions[None], ignore_mask[None],
                                 num_classes=num_classes, **kw)
    return {k: v[0] for k, v in out.items()}
