"""Detection filtering with decode deferred past candidate selection (port of
ground_plane_polling_tpu/ops/filtering.py::filter_detections_fused_batch).

Per image and per candidate set (class x orientation mode): score threshold,
pre-NMS top-k, sign-aware decode of the candidates only, exact greedy NMS,
then a global top-`max_detections` over the pooled sets, padded with -1.
The batch dimension is written out: every step runs on (B, ...) tensors.

Tie-breaking follows lax.top_k (lower index first) through a stable
descending sort. Greedy NMS is the fixpoint iteration of the JAX package;
in eager PyTorch its convergence test is one host sync per round.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import box_coder
from .overlap import iou_matrix

__all__ = ["Detections", "greedy_nms", "filter_detections_fused_batch"]

_NEG_INF = float("-inf")


class Detections(NamedTuple):
    boxes: torch.Tensor         # (B, M, 12)
    dims: torch.Tensor          # (B, M, 3)
    scores: torch.Tensor        # (B, M)
    labels: torch.Tensor        # (B, M) int32
    orientations: torch.Tensor  # (B, M) int32


def _top_k(x: torch.Tensor, k: int):
    """Descending top-k along the last axis, ties to the lower index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered along axis 1 by idx (B, K) -> (B, K, ...)."""
    view = idx.reshape(*idx.shape, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, view.expand(*idx.shape, *x.shape[2:]))


def greedy_nms(boxes4, scores, max_out: int, iou_threshold: float):
    """Exact greedy NMS over score-sorted candidates, as a fixpoint.

    The keep set of greedy NMS is the unique solution of
        keep_i = valid_i AND no kept higher-ranked j overlaps i;
    iterating that equation converges in suppression-chain-depth rounds.

    Args: boxes4 (B, K, 4); scores (B, K) sorted descending, -inf = invalid.
    Returns (idx (B, max_out), valid (B, max_out), score (B, max_out)).
    """
    b, k = scores.shape
    valid0 = scores > _NEG_INF
    rank = torch.arange(k, device=scores.device)
    # suppressor[b, j, i]: higher-ranked valid j overlaps i enough to kill it
    suppressor = ((rank[:, None] < rank[None, :])
                  & (iou_matrix(boxes4, boxes4) > iou_threshold)
                  & valid0[:, :, None])
    keep, prev = valid0, ~valid0
    while bool((keep != prev).any()):  # one host sync per round
        hit = (suppressor & keep[:, :, None]).any(dim=1)
        keep, prev = valid0 & ~hit, keep

    # first max_out kept candidates in score order; ranks past max_out and
    # dropped candidates land in a discarded overflow slot
    kept_rank = torch.where(keep, torch.cumsum(keep, dim=1) - 1, max_out)
    kept_rank = kept_rank.clamp(max=max_out)
    idx = torch.zeros(b, max_out + 1, dtype=torch.long, device=scores.device)
    idx.scatter_(1, kept_rank, rank.expand(b, k).clone())
    idx = idx[:, :max_out]
    n_kept = keep.sum(dim=1, keepdim=True)
    slots = torch.arange(max_out, device=scores.device)
    valid = slots[None, :] < n_kept.clamp(max=max_out)
    score = torch.where(valid, torch.gather(scores, 1, idx), _NEG_INF)
    return idx, valid, score


def _candidate_sets(cls, num_classes, class_specific, orientation_specific):
    """Score / label / orientation per set: each (B, N); cls (B, N, C, 4)."""
    b, n, c, _ = cls.shape

    def full(v):
        return torch.full((b, n), v, dtype=torch.int32, device=cls.device)

    if orientation_specific:
        sets = []
        for o in range(4):
            if class_specific:
                for ci in range(c):
                    sets.append((cls[:, :, ci, o], full(ci), full(o)))
            else:
                sets.append((cls[:, :, :, o].amax(dim=2),
                             cls[:, :, :, o].argmax(dim=2).int(), full(o)))
        return sets
    best_orient = cls.argmax(dim=3).int()    # (B, N, C)
    best_score = cls.amax(dim=3)             # (B, N, C)
    if class_specific:
        return [(best_score[:, :, ci], full(ci), best_orient[:, :, ci])
                for ci in range(c)]
    lab = best_score.argmax(dim=2)
    return [(best_score.amax(dim=2), lab.int(),
             torch.gather(best_orient, 2, lab[..., None])[..., 0])]


def filter_detections_fused_batch(
    anchors,
    deltas,
    dims_raw,
    classification,
    num_classes: int = 1,
    class_specific: bool = True,
    orientation_specific: bool = False,
    nms: bool = True,
    score_threshold: float = 0.05,
    max_detections: int = 100,
    nms_threshold: float = 0.5,
    pre_nms_top_k: int = 1024,
) -> Detections:
    """Args
      anchors: (N, 4); deltas: (B, N, 12) raw regression; dims_raw: (B, N, 3C)
      raw dim regression; classification: (B, N, 8C) sigmoid scores
      (layout [sign0 | sign1], each half indexed 4*c + o).
    """
    b, n, _ = classification.shape
    c = num_classes
    if classification.shape[-1] != 8 * c:
        raise ValueError(
            f"classification width {classification.shape[-1]} != "
            f"8*num_classes ({8 * c})")
    cls = classification.reshape(b, n, 2, c, 4).amax(dim=2)
    k = min(pre_nms_top_k, n)

    def run_set(scores, labels, orients):
        masked = torch.where(scores > score_threshold, scores, _NEG_INF)
        top_scores, top_idx = _top_k(masked, k)
        # decode the candidates only; the sign half comes from the argmax
        # of the full classification row (first index on ties)
        cls_rows = _take(classification, top_idx)
        sign = torch.where(cls_rows.argmax(dim=-1) < 4 * c, -1.0, 1.0).to(
            deltas.dtype)
        cand_boxes = box_coder.decode_boxes(
            anchors[top_idx], _take(deltas, top_idx), sign)
        if nms:
            sel, valid, sel_scores = greedy_nms(
                cand_boxes[..., :4], top_scores, max_detections,
                nms_threshold)
            anchor_idx = torch.gather(top_idx, 1, sel)
            return (anchor_idx, _take(cand_boxes, sel), valid, sel_scores,
                    torch.gather(labels, 1, anchor_idx),
                    torch.gather(orients, 1, anchor_idx))
        m = min(max_detections, k)
        anchor_idx = top_idx[:, :m]
        return (anchor_idx, cand_boxes[:, :m], top_scores[:, :m] > _NEG_INF,
                top_scores[:, :m], torch.gather(labels, 1, anchor_idx),
                torch.gather(orients, 1, anchor_idx))

    parts = [run_set(*s) for s in _candidate_sets(
        cls, c, class_specific, orientation_specific)]
    idx, cand_boxes, valid, score, label, orient = (
        torch.cat([p[i] for p in parts], dim=1) for i in range(6))

    # global top-k over the pooled sets; a short pool is padded with -inf
    pooled = torch.where(valid, score, _NEG_INF)
    k_out = min(max_detections, pooled.shape[1])
    top_score, top = _top_k(pooled, k_out)
    if k_out < max_detections:
        pad = max_detections - k_out
        top_score = torch.cat(
            [top_score, top_score.new_full((b, pad), _NEG_INF)], dim=1)
        top = torch.cat([top, top.new_zeros((b, pad))], dim=1)
    keep = top_score > _NEG_INF

    sel_anchor = torch.gather(idx, 1, top)
    sel_label = torch.gather(label, 1, top)
    dims_all = _take(dims_raw, sel_anchor).reshape(b, max_detections, c, 3)
    dims_sel = box_coder.decode_dims(
        torch.gather(dims_all, 2, sel_label.long()[:, :, None, None].expand(
            b, max_detections, 1, 3))[:, :, 0])
    return Detections(
        boxes=torch.where(keep[..., None], _take(cand_boxes, top), -1.0),
        dims=torch.where(keep[..., None], dims_sel, -1.0),
        scores=torch.where(keep, top_score, -1.0),
        labels=torch.where(keep, sel_label, -1).to(torch.int32),
        orientations=torch.where(keep, torch.gather(orient, 1, top),
                                 -1).to(torch.int32),
    )
