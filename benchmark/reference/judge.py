"""The comparison that decides `correct`: the program's outputs of a
sample of finished frames, judged by the plain reference on the same
frames, cameras, planes and weights.

The reference runs the network in float32 with TF32 off (for an int8
configuration every conv at 8 bits, on scales it calibrates itself over
the same frames the program calibrates on) and gives every anchor's
score, decoded box (both sign halves) and dimensions. Each valid
detection of the program is explained by the anchor and sign half whose
reference box lies nearest to it in pixels (over all 12 coordinates);
the numbers are the largest over the sample's frames (short_frames:
their count; the choice gap: their mean; and, for the score, box and
dimension gaps, `*.p50`, the largest over the batch positions of the
median over a position's detections, so that one bad batch position
shows):

  * kept_gap: how many more or fewer detections a frame kept than the
    reference's own filter (threshold, top-k, serial greedy NMS) keeps;
    not exact: where a frame's top-k run out before max_detections are
    kept, which candidates make the top-k, and the overlaps near the
    threshold, move the count by a few (not compared);
  * short_frames: frames where the program kept fewer than
    max_detections while the reference's filter kept them all within the
    first SURELY_FULL of its top-k, so that no rounding can run the
    program's top-k out (exact, 0);
  * choice_gap, in logits, the mean over the frames (its largest swings
    with one near tie): how far the best reference score of the
    reference's top-k candidates that no kept box covers (IoU with every
    kept box at most the NMS threshold less IOU_MARGIN, so that a
    rounding of the boxes does not flip it) lies above the least
    reference score of the kept anchors (where fewer than max_detections
    were kept, above the top-k's last score, or the score threshold):
    greedy NMS leaves no such candidate above what it keeps, so a filter
    that keeps too few, keeps low scorers over high ones, or suppresses
    too much, reads high;
  * score_gap, in logits (the top scores lie near 1, where a sigmoid
    flattens every difference): |score - the reference's score of that
    anchor|, and how far the reference's score of the detection's
    orientation, or of its sign half, lies below the anchor's best (0
    unless a near tie went the other way; of the sign halves, the best of
    those the box cannot tell apart);
  * box_gap: the largest coordinate gap to that reference box over the
    anchor's width (x) or height (y);
  * dims_gap: metres between the dimensions and the anchor's;
  * nms_overlap: how far any two kept boxes of a frame overlap beyond the
    NMS threshold, by the IoU in the program's own float32 operations
    (greedy NMS keeps none: exact, 0);
  * residual_gap: metres between the program's residual and the
    reference's residual of the plane the program chose, and by which that
    one lies above the least residual of the planes that surely qualify
    (a chosen plane that surely does not reads 16.7: `_residual_gaps`);
  * plane_gap: the chosen plane against the nearest normalised plane of
    the database;
  * keypoint_gap: the 3D keypoints against the reference's on the chosen
    plane, over (1 + |X|)^2, since a rounding in a grazing ray's dot
    product moves X by about |X|^2 times it;
  * pose_gap: the pose solved by the reference from the program's
    keypoints: location and dimensions over (1 + |v|)^2, and the
    rotation matrices' largest entry gap.
"""

from __future__ import annotations

import contextlib

import torch

from . import model as ref_model
from . import pipeline as ref

__all__ = ["NUMBERS", "judge", "reference_weights"]

NUMBERS = ("kept_gap", "short_frames", "choice_gap", "score_gap",
           "box_gap", "dims_gap", "nms_overlap", "residual_gap",
           "plane_gap", "keypoint_gap", "pose_gap")
IOU_MARGIN = 0.15
SURELY_FULL = 0.75


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32, not TF32, for the reference."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def reference_weights(weights, device):
    """The weights both sides were given, as float32 on `device`."""
    return {k: v.to(device=device, dtype=torch.float32)
            for k, v in weights.items()}


def _gap(got, want, scale=None):
    """Largest |got - want| (over `scale`), per leading row; equal
    non-finite values count as 0, a non-finite on one side only as inf."""
    diff = (got - want).abs()
    if scale is not None:
        diff = diff / scale
    both = ~torch.isfinite(got) & ~torch.isfinite(want)
    same = both & ((got == want) | (torch.isnan(got) & torch.isnan(want)))
    diff = torch.where(same, 0.0, diff)
    diff = torch.where(torch.isnan(diff), float("inf"), diff)
    return diff.reshape(len(diff), -1).amax(dim=1)


VOTE_MARGIN = 1e-3  # metres
WIND_MARGIN = 1e-4  # of |X_l - X_m| |X_r - X_m|
_SIDED = [6, 10]  # xm, xt: the box coordinates the sign half moves
_UNSIDED = [0, 1, 2, 3, 4, 5, 7, 8, 9, 11]


def _residual_gaps(board, p, reported):
    """Metres by which each detection's polling departs from the
    reference: the reported residual against the reference's of the
    chosen plane `p`, and how far that one lies above the least of the
    planes that surely qualify. A plane qualifies with the most votes and
    the right winding; a poll within VOTE_MARGIN of the vote threshold, or
    a winding within WIND_MARGIN of 0, can go either way in float32, so a
    plane surely qualifies, or may, by the margins' worse or better side
    (the program may choose any that may; one that surely does not reads
    100 / 6)."""
    mean = board.polls.sum(-1) / 6.0                     # (D, P)
    lo = (board.polls <= ref.POLL_THRESHOLD_M - VOTE_MARGIN).sum(-1)
    hi = (board.polls <= ref.POLL_THRESHOLD_M + VOTE_MARGIN).sum(-1)
    tol = WIND_MARGIN * board.wind_scale
    sure = (board.wind >= tol) & (lo >= hi.amax(-1, keepdim=True))
    may = (board.wind >= -tol) & (hi >= lo.amax(-1, keepdim=True))
    least = torch.where(sure, mean, float("inf")).amin(dim=-1)
    rows = torch.arange(len(p), device=p.device)
    none = ref.DISQUALIFIED / 6.0
    chose_none = reported >= none * (1.0 - 1e-6)
    report = torch.where(chose_none, 0.0, (reported - mean[rows, p]).abs())
    choice = torch.where(
        chose_none, torch.where(torch.isinf(least), 0.0, none - least),
        torch.where(may[rows, p],
                    (mean[rows, p] - least).clamp(min=0.0), none))
    return torch.maximum(report, choice)


def _logit(p):
    """Scores as logits, where float32 resolves sigmoid outputs near 1."""
    return torch.logit(p.float(), eps=1e-7)


def _point_scale(points):
    """(1 + |X|)^2 of each 3D point (..., 3), broadcast over xyz."""
    norm = torch.linalg.vector_norm(points, dim=-1, keepdim=True)
    return (1.0 + torch.nan_to_num(norm, nan=0.0, posinf=0.0)) ** 2


@torch.no_grad()
def judge(cfg, inputs, samples, device) -> dict:
    """numbers (NUMBERS) over `samples`: [(frame (H, W, 3) uint8, P_inv
    (4, 3), outputs {field: numpy (M, ...)}, batch position)]; `inputs`:
    the weights, the frame pool (an int8 configuration's program
    calibrated on its first frames) and the planes both sides were given.
    Besides, `score_gap.p50`, `box_gap.p50` and `dims_gap.p50`: the
    largest over the batch positions of that gap's median over a
    position's detections, steadier from seed to seed than the largest
    gap."""
    device = torch.device(device)
    out = dict.fromkeys(NUMBERS, 0.0)
    per_position, choices = {}, []
    planes = inputs.planes
    with no_tf32():
        w = reference_weights(inputs.weights, device)
        conv = ref_model.float_conv
        if cfg["int8"]:
            conv = ref_model.quantized_conv(
                ref_model.calibrate(w, [
                    ref.network_input(inputs.pool.frames[i:i + 1], device)
                    for i in range(cfg["calibration_frames"])]), 8)
        anchors = torch.from_numpy(ref.anchors_for_shape(cfg["canvas"])).to(
            device)
        for frame, P_inv, outputs, position in samples:
            raw = ref_model.forward(
                w, ref.network_input(frame[None], device), conv)
            numbers = _frame(cfg, anchors, {k: v[0] for k, v in raw.items()},
                             torch.as_tensor(P_inv, device=device),
                             planes.float(),
                             {k: torch.as_tensor(v, device=device)
                              for k, v in outputs.items()})
            choices.append(numbers.pop("choice_gap"))
            for k, v in numbers.items():
                if torch.is_tensor(v):  # one gap a detection
                    per_position.setdefault((k, position), []).append(v)
                    continue
                v = float("inf") if v != v else v  # NaN fails
                out[k] = (out[k] + v if k == "short_frames"
                          else max(out[k], v))
    for (k, _), v in per_position.items():
        v = torch.nan_to_num(torch.cat(v), nan=float("inf"))
        out[k] = max(out.get(k, 0.0), float(v.median()))
    out["choice_gap"] = sum(choices) / len(choices)
    return out


def _choice_gap(cfg, anchors, raw, boxes, kept, kept_logits):
    """Logits by which the best reference candidate, not kept (`kept`: the
    anchors that explain the kept boxes) and covered by no kept box, lies
    above the least kept (or the score threshold). A box of no area
    covers nothing, itself included."""
    cls = raw["classification"]
    score = cls.amax(dim=-1)
    masked = torch.where(score > cfg["score_threshold"], score,
                         float("-inf"))
    top = torch.sort(masked, descending=True, stable=True).indices
    top = top[:cfg["pre_nms_top_k"]]
    top = top[torch.isfinite(masked[top])]
    if not len(top):
        return 0.0
    sign = torch.where(cls.argmax(dim=-1) < 4, -1.0, 1.0)
    cand = ref.decode_boxes(anchors[top], raw["regression"][top],
                            sign[top])[:, :4]
    free = ~torch.isin(top, kept)
    if len(boxes):
        over = ref.iou_matrix(cand, boxes[:, :4]).amax(dim=1)
        free &= over <= cfg["nms_threshold"] - IOU_MARGIN
    if not bool(free.any()):
        return 0.0
    if len(kept_logits) >= cfg["max_detections"]:
        floor = kept_logits.min()
    elif int(torch.isfinite(masked).sum()) > cfg["pre_nms_top_k"]:
        # fewer kept: the filter went through all of its top-k, and a
        # candidate outside them scores no more than the k-th
        floor = _logit(score[top[-1]])
    else:
        floor = _logit(torch.tensor(cfg["score_threshold"]))
    return max(0.0, float(_logit(score[top][free]).max() - floor))


def _frame(cfg, anchors, raw, P_inv, planes, prog) -> dict:
    cls, reg = raw["classification"], raw["regression"]
    valid = prog["labels"] >= 0
    scores = prog["scores"][valid].float()
    _, kept, _ = ref.greedy_filter(anchors, raw, cfg)
    full = (len(kept) >= cfg["max_detections"]
            and max(kept) < SURELY_FULL * cfg["pre_nms_top_k"])
    numbers = {"kept_gap": float(abs(len(scores) - len(kept))),
               "short_frames": float(full and len(scores)
                                     < cfg["max_detections"])}
    if not len(scores):
        none = scores.new_empty(0)
        numbers["choice_gap"] = _choice_gap(cfg, anchors, raw,
                                            none.reshape(0, 12),
                                            none.long(), none)
        return numbers
    boxes = prog["boxes"][valid].float()
    dims = prog["dims"][valid].float()
    orient = prog["orientations"][valid].long()

    # every anchor's reference box, both sign halves: (A, 2, 12)
    signs = torch.tensor([-1.0, 1.0], device=cls.device)
    ref_boxes = ref.decode_boxes(anchors[:, None].expand(-1, 2, -1),
                                 reg[:, None].expand(-1, 2, -1),
                                 signs.expand(len(reg), 2))
    wh = torch.stack([anchors[:, 2] - anchors[:, 0],
                      anchors[:, 3] - anchors[:, 1]], dim=-1)
    norm = wh.repeat(1, 6)[:, None]                      # (A, 1, 12)
    flat = torch.cat([
        (chunk[:, None, None] - ref_boxes[None]).abs().amax(dim=-1)
        .reshape(len(chunk), -1).argmin(dim=1)           # nearest, pixels
        for chunk in boxes.split(8)])
    a, h = flat // 2, flat % 2
    rows = torch.arange(len(a), device=a.device)
    box = ((boxes - ref_boxes[a, h]).abs() / norm[a, 0]).amax(dim=1)
    numbers["box_gap"] = float(box.max())
    numbers["box_gap.p50"] = box
    logit = _logit(cls[a]).reshape(-1, 2, 4)
    best = logit.amax(dim=(1, 2))
    # the sign halves the box cannot tell apart: those whose m and t x
    # coordinates lie within twice the box's own gap of it
    gap = (boxes[:, None] - ref_boxes[a]).abs()          # (D, 2, 12)
    sided = gap[..., _SIDED].amax(dim=-1)                # (D, 2)
    other = gap[:, 0, _UNSIDED].amax(dim=-1, keepdim=True)
    fits = sided <= 2.0 * (sided.amin(dim=1, keepdim=True) + other)
    half = torch.where(fits, logit.amax(dim=2), float("-inf")).amax(dim=1)
    score = torch.stack([(_logit(scores) - best).abs(),
                         best - logit[rows, :, orient].amax(dim=-1),
                         best - half]).amax(dim=0)
    numbers["score_gap"] = float(score.max())
    numbers["score_gap.p50"] = score
    numbers["choice_gap"] = _choice_gap(cfg, anchors, raw, boxes, a, best)
    dim = _gap(dims, ref.decode_dims(raw["regression_dim"][a]))
    numbers["dims_gap"] = float(dim.max())
    numbers["dims_gap.p50"] = dim

    iou = ref.iou_matrix(boxes[:, :4], boxes[:, :4])
    iou = iou.triu(diagonal=1)
    numbers["nms_overlap"] = max(0.0, float(iou.max())
                                 - cfg["nms_threshold"])

    board = ref.scoreboard(boxes, dims, orient, P_inv, planes)
    plane_d = (board.planes[None]
               - prog["keyplanes"][valid].float()[:, 0, None]
               ).abs().amax(dim=-1)                      # (D, P)
    plane_gap, p = plane_d.min(dim=-1)
    numbers["plane_gap"] = float(plane_gap.max())
    numbers["residual_gap"] = float(_residual_gaps(
        board, p, prog["residuals"][valid].float()).max())
    kp_ref = board.keypoints[rows, p]                    # (D, 4, 3)
    kp = prog["keypoints"][valid].float()
    numbers["keypoint_gap"] = float(_gap(kp, kp_ref,
                                         _point_scale(kp_ref)).max())

    if cfg["with_pose"]:
        loc, ang, pdims = ref.solve_pose(kp, orient.clamp(min=0), dims)
        gaps = torch.stack([
            _gap(prog["locations"][valid].float(), loc, _point_scale(loc)),
            _gap(prog["pose_dims"][valid].float(), pdims,
                 _point_scale(pdims)),
            _gap(ref.matrix_from_rodrigues(prog["angles"][valid]),
                 ref.matrix_from_rodrigues(ang))])
        numbers["pose_gap"] = float(gaps.max())
    return numbers
