"""Plain reference of the detect call after the network: anchors, decode,
the filter with exact greedy NMS, ground-plane polling and the pose
solve. Frozen copies of the plain versions the measured program keeps
beside its kernels, in plain torch, importing nothing of the program.

  * anchors: P3..P7, sizes 32..512, strides 8..128, ratios (0.5, 1, 2) x
    scales 2^(0, 1/3, 2/3) and 2^(-2/3), centres at (i + 0.5) stride,
    position-major and anchor-minor;
  * decode: 12 regression values (box corners, then the l, m, r, t image
    keypoints), normalised by the dataset's mean and std; the m and t x
    offsets are magnitudes whose side comes from the sign half of the
    8C-wide classification row (its argmax, first index on ties);
  * filter (one class, class-specific, orientations pooled): each
    anchor's score is the max of its 8 sigmoid outputs, its orientation
    the argmax over the 4 orientations of the max over the two sign
    halves; threshold 0.05, the 1,024 best (ties to the lower index),
    greedy NMS at IoU 0.5 to 100 kept, padded with -1;
  * polling: every keypoint's ray through P_inv, intersected with every
    (normalised) road plane; six polls of keypoint distances against the
    predicted dimensions by orientation, a vote where a residual is at
    most 0.7 m; planes below the most votes or winding the wrong way are
    disqualified; the least mean residual wins;
  * pose: the box frame from the polled keypoints, its nearest rotation
    as a Rodrigues vector, the bottom-face centre and the measured
    height and length.

`dtype` runs polling and the pose solve in a lower precision: the
control of those stages.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["BGR_MEAN", "network_input", "anchors_for_shape",
           "decode_boxes", "decode_dims", "iou_matrix", "greedy_nms",
           "greedy_filter", "filter_frame", "normalize_planes",
           "Board", "scoreboard", "fit_road_planes", "solve_pose",
           "matrix_from_rodrigues", "detect"]

BGR_MEAN = (103.939, 116.779, 123.68)
BOX_MEAN = (-0.0373, -0.0165, 0.0373, 0.0171, -0.0286, -0.0478, 0.2929,
            0.0114, 0.0288, -0.0589, 0.2932, -0.0007)
BOX_STD = (0.1957, 0.1896, 0.1957, 0.1897, 0.1967, 0.2034, 0.2046, 0.1898,
           0.1964, 0.2052, 0.2048, 0.1903)
DIM_MEAN = (1.6570, 1.7999, 4.2907)
DIM_STD = (0.2681, 0.2243, 0.6281)
POLL_THRESHOLD_M = 0.7
DISQUALIFIED = 100.0
EPS = 1e-12


def network_input(frames, device):
    """uint8 BGR canvases (B, H, W, 3) -> float32 (B, 3, H, W) on
    `device`, the BGR mean subtracted."""
    mean = torch.tensor(BGR_MEAN, device=device)
    return (torch.as_tensor(frames).to(device).float() - mean).permute(
        0, 3, 1, 2)


def anchors_for_shape(image_shape) -> np.ndarray:
    """(A, 4) float32 anchors (x1, y1, x2, y2) of a padded canvas."""
    ratios = np.array([0.5, 1.0, 2.0])
    scales = np.array([2.0 ** (-2.0 / 3.0), 1.0, 2.0 ** (1.0 / 3.0),
                       2.0 ** (2.0 / 3.0)])
    out = []
    for lvl, stride, size in zip((3, 4, 5, 6, 7), (8, 16, 32, 64, 128),
                                 (32, 64, 128, 256, 512)):
        fh = (int(image_shape[0]) + 2 ** lvl - 1) // 2 ** lvl
        fw = (int(image_shape[1]) + 2 ** lvl - 1) // 2 ** lvl
        r = np.repeat(ratios, len(scales))
        side = size * np.tile(scales, len(ratios))
        w = np.sqrt(side * side / r)
        h = w * r
        base = np.stack([-w / 2, -h / 2, w / 2, h / 2], axis=1)
        sx = (np.arange(fw) + 0.5) * stride
        sy = (np.arange(fh) + 0.5) * stride
        gx, gy = np.meshgrid(sx, sy)
        shifts = np.stack([gx.ravel(), gy.ravel(), gx.ravel(), gy.ravel()],
                          axis=1)
        out.append((base[None] + shifts[:, None]).reshape(-1, 4))
    return np.concatenate(out).astype(np.float32)


def _const(values, like):
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def decode_boxes(anchors, deltas, sign):
    """anchors (..., 4), deltas (..., 12), sign (...) in {-1, 1} ->
    (..., 12) pixels."""
    w = anchors[..., 2] - anchors[..., 0]
    h = anchors[..., 3] - anchors[..., 1]
    cx = (anchors[..., 0] + anchors[..., 2]) / 2.0
    d = deltas * _const(BOX_STD, deltas) + _const(BOX_MEAN, deltas)
    a = anchors
    return torch.stack([
        a[..., 0] + d[..., 0] * w, a[..., 1] + d[..., 1] * h,
        a[..., 2] + d[..., 2] * w, a[..., 3] + d[..., 3] * h,
        a[..., 0] + d[..., 4] * w, a[..., 3] + d[..., 5] * h,
        cx + d[..., 6] * w * sign, a[..., 3] + d[..., 7] * h,
        a[..., 2] + d[..., 8] * w, a[..., 3] + d[..., 9] * h,
        cx + d[..., 10] * w * sign, a[..., 1] + d[..., 11] * h], dim=-1)


def decode_dims(raw):
    """(..., 3) network dimensions -> metres (h, w, l)."""
    return raw * _const(DIM_STD, raw) + _const(DIM_MEAN, raw)


def iou_matrix(a, b):
    """IoU of every box of a (..., N, 4) with every box of b (..., K, 4),
    the union clamped at float64's eps, in the float32 operations and order
    the program's greedy NMS uses."""
    a_ = a[..., :, None, :]
    b_ = b[..., None, :, :]
    iw = (torch.minimum(a_[..., 2], b_[..., 2])
          - torch.maximum(a_[..., 0], b_[..., 0])).clamp(min=0.0)
    ih = (torch.minimum(a_[..., 3], b_[..., 3])
          - torch.maximum(a_[..., 1], b_[..., 1])).clamp(min=0.0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    inter = iw * ih
    union = (area_a[..., :, None] + area_b[..., None, :] - inter).clamp(
        min=float(np.finfo(np.float64).eps))
    return inter / union


def greedy_nms(boxes4, scores, max_out: int, threshold: float):
    """Sequential greedy NMS of one candidate set: boxes4 (K, 4), scores
    (K,) with -inf for invalid; returns the kept indices in order."""
    work = scores.clone()
    kept = []
    for _ in range(min(max_out, len(scores))):
        j = int(work.argmax())
        if work[j] == float("-inf"):
            break
        kept.append(j)
        iou = iou_matrix(boxes4[j][None], boxes4)[0]
        work = torch.where(iou > threshold, float("-inf"), work)
        work[j] = float("-inf")
    return kept


def greedy_filter(anchors, raw, cfg):
    """The filter's choice in one frame: (top, kept, boxes): the top-k
    candidate anchors in score order, the positions in `top` that greedy
    NMS keeps, in the order it keeps them, and the candidates' boxes."""
    cls = raw["classification"]
    scores = cls.amax(dim=-1)
    sign = torch.where(cls.argmax(dim=-1) < 4, -1.0, 1.0)
    masked = torch.where(scores > cfg["score_threshold"], scores,
                         float("-inf"))
    order = torch.sort(masked, descending=True, stable=True).indices
    top = order[:min(cfg["pre_nms_top_k"], len(order))]
    boxes = decode_boxes(anchors[top], raw["regression"][top], sign[top])
    kept = greedy_nms(boxes[:, :4], masked[top], cfg["max_detections"],
                      cfg["nms_threshold"])
    return top, kept, boxes


def filter_frame(anchors, raw, cfg):
    """One frame's detections from its dense outputs raw (each (A, .)):
    dict of boxes (M, 12), dims (M, 3), scores (M,), labels (M,),
    orientations (M,), padded to max_detections with -1."""
    cls = raw["classification"]
    m = cfg["max_detections"]
    scores = cls.amax(dim=-1)
    orient = cls.reshape(-1, 2, 4).amax(dim=1).argmax(dim=-1)
    top, kept, boxes = greedy_filter(anchors, raw, cfg)
    idx = top[kept]
    out = {"boxes": torch.full((m, 12), -1.0, device=cls.device),
           "dims": torch.full((m, 3), -1.0, device=cls.device),
           "scores": torch.full((m,), -1.0, device=cls.device),
           "labels": torch.full((m,), -1, dtype=torch.int32,
                                device=cls.device),
           "orientations": torch.full((m,), -1, dtype=torch.int32,
                                      device=cls.device)}
    n = len(kept)
    out["boxes"][:n] = boxes[kept]
    out["dims"][:n] = decode_dims(raw["regression_dim"][idx])
    out["scores"][:n] = scores[idx]
    out["labels"][:n] = 0
    out["orientations"][:n] = orient[idx].int()
    return out


def normalize_planes(planes):
    """Sign so that b < 0, scaled to a unit normal."""
    planes = planes * -torch.sign(planes[..., 1:2])
    return planes / torch.linalg.vector_norm(planes[..., 0:3], dim=-1,
                                             keepdim=True)


def _expected(dims, orient):
    h, w, l = dims[..., 0], dims[..., 1], dims[..., 2]
    d_hw = torch.sqrt(h * h + w * w)
    d_wl = torch.sqrt(w * w + l * l)
    d_hl = torch.sqrt(h * h + l * l)
    onehot = (orient[..., None] == torch.arange(4, device=orient.device)).to(
        dims.dtype)

    def pick(*d):
        return (onehot * torch.stack(d, dim=-1)).sum(-1)

    return torch.stack([h, pick(l, w, w, l), pick(w, l, l, w), d_wl,
                        pick(d_hl, d_hw, d_hw, d_hl),
                        pick(d_hw, d_hl, d_hl, d_hw)], dim=-1)


class Board(NamedTuple):
    """Every (detection, plane) pair of one frame."""
    polls: torch.Tensor       # (D, P, 6) each poll's residual, metres
    wind: torch.Tensor        # (D, P) y of (X_l - X_m) x (X_r - X_m)
    wind_scale: torch.Tensor  # (D, P) |X_l - X_m| |X_r - X_m|
    keypoints: torch.Tensor   # (D, P, 4, 3) X_l, X_m, X_r, X_t
    planes: torch.Tensor      # (P, 4) normalised


def scoreboard(boxes, dims, orient, P_inv, planes, dtype=torch.float32):
    """The polls of every plane for every detection of one frame: boxes
    (D, 12), dims (D, 3), orient (D,), P_inv (4, 3), planes (P, 4),
    computed in `dtype`."""
    boxes, dims, P_inv, planes = (t.to(dtype) for t in
                                  (boxes, dims, P_inv, planes))
    pn = normalize_planes(planes)
    d = boxes.shape[0]
    kp = boxes[:, 4:12].reshape(d, 4, 2)
    kp_h = torch.cat([kp, kp.new_ones(d, 4, 1)], dim=-1)
    rays = torch.einsum("ij,dkj->dki", P_inv, kp_h)[..., 0:3]
    rays = rays * torch.sign(rays[..., 2:3])
    expected = _expected(dims, orient)
    normals, offsets = pn[:, 0:3], pn[:, 3]
    ndot = torch.einsum("pc,dkc->dpk", normals, rays[:, 0:3])
    scale = -offsets[None, :, None] / ndot
    X = rays[:, None, 0:3, :] * torch.abs(scale)[..., None]
    X_l, X_m, X_r = X[..., 0, :], X[..., 1, :], X[..., 2, :]
    wind = torch.linalg.cross(X_l - X_m, X_r - X_m, dim=-1)[..., 1]
    wind_scale = (torch.linalg.vector_norm(X_l - X_m, dim=-1)
                  * torch.linalg.vector_norm(X_r - X_m, dim=-1))
    n_b = normals[None]
    d_t = rays[:, None, 3, :]
    perp = torch.linalg.cross(d_t, torch.linalg.cross(n_b, d_t, dim=-1),
                              dim=-1)
    t = (perp * X_m).sum(-1) / (perp * n_b).sum(-1)
    X_t = X_m - t[..., None] * n_b
    polls = torch.stack([
        torch.abs(torch.linalg.vector_norm(a - c, dim=-1)
                  - expected[:, i, None])
        for i, (a, c) in enumerate(((X_m, X_t), (X_l, X_m), (X_m, X_r),
                                    (X_l, X_r), (X_l, X_t), (X_r, X_t)))],
        dim=-1)
    keypoints = torch.cat([X, X_t[..., None, :]], dim=-2)
    return Board(polls, wind, wind_scale, keypoints, pn)


def fit_road_planes(boxes, dims, orient, P_inv, planes, dtype=torch.float32):
    """The winning plane of each detection: keypoints (D, 4, 3), keyplanes
    (D, 1, 4), residuals (D,), as float32. A plane below the most votes,
    or winding the wrong way, is disqualified (residual 100 / 6)."""
    b = scoreboard(boxes, dims, orient, P_inv, planes, dtype)
    votes = (b.polls <= POLL_THRESHOLD_M).sum(-1)
    res = torch.where((b.wind < 0) | (votes < votes.amax(-1, keepdim=True)),
                      DISQUALIFIED, b.polls.sum(-1)) / 6.0
    best = torch.argmin(res, dim=-1)
    rows = torch.arange(len(best), device=best.device)
    return (b.keypoints[rows, best].float(), b.planes[best][:, None].float(),
            res[rows, best].float())


def _rodrigues(R):
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos)
    sin = torch.sqrt(torch.clamp(1.0 - cos * cos, 0.0, 1.0))
    r = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    axis_generic = r / torch.clamp(2.0 * sin, min=EPS)[..., None]
    M = R + torch.eye(3, dtype=R.dtype, device=R.device)
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(M, -1, k[..., None, None].expand(*M.shape[:-1], 1))
    col = col[..., 0]
    axis_pi = col / torch.clamp(torch.linalg.vector_norm(col, dim=-1,
                                                         keepdim=True),
                                min=EPS)
    near_pi = cos < -1.0 + 1e-6
    small = sin < 1e-6
    axis = torch.where(near_pi[..., None], axis_pi, axis_generic)
    return torch.where((small & ~near_pi)[..., None], r / 2.0,
                       theta[..., None] * axis)


def solve_pose(keypoints, orient, dims, dtype=torch.float32):
    """keypoints (..., 4, 3), orient (...), dims (..., 3) -> (locations,
    angles as Rodrigues vectors, dimensions (h, w, edge)), float32."""
    keypoints, dims = keypoints.to(dtype), dims.to(dtype)
    X_l, X_m, X_r, X_t = (keypoints[..., i, :] for i in range(4))
    o = orient.long()
    X_sel = torch.where(((o == 1) | (o == 2))[..., None], X_r, X_l)
    h = torch.linalg.vector_norm(X_t - X_m, dim=-1)
    edge = torch.linalg.vector_norm(X_sel - X_m, dim=-1)
    w = dims[..., 1]
    o4 = o % 4
    s_x = torch.where(o4 < 2, 1.0, -1.0).to(dtype)
    s_l = torch.where(o4 % 2 == 0, 1.0, -1.0).to(dtype)
    y_dir = (X_m - X_t) / torch.clamp(h, min=EPS)[..., None]
    x_dir = s_x[..., None] * (X_m - X_sel) / torch.clamp(edge,
                                                        min=EPS)[..., None]
    z_dir = torch.linalg.cross(x_dir, y_dir, dim=-1)
    loc = (X_m + X_sel) / 2.0 + s_l[..., None] * z_dir * w[..., None] / 2.0
    R = torch.stack([x_dir, y_dir, z_dir], dim=-1)

    def unit(a):
        return a / torch.clamp(torch.linalg.vector_norm(a, dim=-1,
                                                        keepdim=True),
                               min=EPS)

    x, y, z = R[..., 0], R[..., 1], R[..., 2]
    u, v = unit(x + y), unit(x - y)
    half = math.sqrt(0.5)
    Rn = torch.stack([(u + v) * half, (u - v) * half, unit(z)], dim=-1)
    finite = torch.isfinite(R).all(dim=-1).all(dim=-1)
    angles = torch.where(finite[..., None], _rodrigues(Rn), float("nan"))
    return (loc.float(), angles.float(),
            torch.stack([h, w, edge], dim=-1).float())


def matrix_from_rodrigues(vec):
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3), float64."""
    vec = vec.double()
    theta = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    axis = vec / torch.clamp(theta, min=EPS)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([torch.stack([zero, -z, y], -1),
                     torch.stack([z, zero, -x], -1),
                     torch.stack([-y, x, zero], -1)], -2)
    t = theta[..., None]
    eye = torch.eye(3, dtype=vec.dtype, device=vec.device)
    return eye + torch.sin(t) * K + (1.0 - torch.cos(t)) * (K @ K)


def detect(raw_frame, anchors, P_inv, planes, cfg, dtype=torch.float32):
    """The whole call after the network for one frame, as the program
    returns it: a dict of float32 / int32 tensors."""
    out = filter_frame(anchors, raw_frame, cfg)
    kp, kpl, res = fit_road_planes(out["boxes"], out["dims"],
                                   out["orientations"], P_inv, planes, dtype)
    out.update(keypoints=kp, keyplanes=kpl, residuals=res)
    if cfg["with_pose"]:
        loc, ang, pdims = solve_pose(kp, out["orientations"].clamp(min=0),
                                     out["dims"], dtype)
        out.update(locations=loc, angles=ang, pose_dims=pdims)
    return out
