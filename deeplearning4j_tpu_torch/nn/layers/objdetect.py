"""Object detection output layer (YOLOv2).

Counterpart of the JAX package's `nn/layers/objdetect.py` (DL4J
`Yolo2OutputLayer`): the YOLOv2 loss head of the TinyYOLO and YOLO2 zoo
models, and the host-side decoding (`decode_detections`) and class-wise
non-max suppression.

- Activations are NHWC (B, H, W, A*(5+C)). Labels are (B, H, W, 4+C):
  [x1, y1, x2, y2] in grid units, then the one-hot class.
- The loss is the reference's, term for term, with no loop over cells
  and no host copy: tensor ops only, so it runs inside a captured train
  step. It accumulates in f32 or wider (f32 under bf16 compute, f64
  under f64 gradient checking). The responsible anchor is the first IOU
  maximum, as `jnp.argmax` picks it (a cell whose IOUs are all 0 takes
  anchor 0).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, LayerConf, register_layer,
)


def _anchor_sizes(anchors, dtype, device):
    """The (A, 2) anchor sizes on `device`, made by fill kernels and not
    copied from the host: a host copy would be a synchronization, and a
    CUDA graph cannot capture it."""
    return torch.stack([torch.stack([
        torch.full((), float(v), dtype=dtype, device=device) for v in a])
        for a in anchors])


def _split_predictions(x, n_anchors: int, n_classes: int):
    """(B,H,W,A*(5+C)) -> xy (sigmoid), wh (raw), conf (sigmoid), class
    logits."""
    b, h, w, _ = x.shape
    x = x.reshape(b, h, w, n_anchors, 5 + n_classes)
    txy = torch.sigmoid(x[..., 0:2])           # offset within the cell
    twh = x[..., 2:4]                          # raw; box = anchor * exp(twh)
    conf = torch.sigmoid(x[..., 4])
    cls_logits = x[..., 5:]
    return txy, twh, conf, cls_logits


@register_layer
@dataclasses.dataclass(frozen=True)
class Yolo2OutputLayer(LayerConf):
    """YOLOv2 loss head (DL4J Yolo2OutputLayer); `lambda_coord` and
    `lambda_no_obj` default to DL4J's 5.0 and 0.5."""
    anchors: Tuple[Tuple[float, float], ...] = ()
    n_classes: int = 20
    lambda_coord: float = 5.0
    lambda_no_obj: float = 0.5

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        """Activated predictions: sigmoid(xy, conf), anchor * exp(wh),
        softmax(classes) (DL4J Yolo2OutputLayer.activate())."""
        b, h, w, _ = x.shape
        n_a = len(self.anchors)
        txy, twh, conf, cls_logits = _split_predictions(x, n_a,
                                                        self.n_classes)
        wh = _anchor_sizes(self.anchors, x.dtype, x.device) \
            * torch.exp(twh)
        probs = torch.softmax(cls_logits, dim=-1)
        out = torch.cat([txy, wh, conf[..., None], probs], dim=-1)
        return out.reshape(b, h, w, n_a * (5 + self.n_classes)), state

    def score(self, params, x, labels, *, train=False, generator=None,
              mask=None):
        """The YOLOv2 loss (DL4J Yolo2OutputLayer.computeScore), divided by
        the batch: coordinate SSE on the responsible anchors (xy within
        the cell, sqrt of wh in grid units; `lambda_coord`), confidence
        against the IOU there and against 0 elsewhere (`lambda_no_obj`),
        and class SSE on the softmax."""
        f32 = torch.promote_types(torch.float32, x.dtype)
        x = x.to(f32)
        labels = labels.to(f32)
        b, h, w, _ = x.shape
        n_a = len(self.anchors)
        txy, twh, conf, cls_logits = _split_predictions(x, n_a,
                                                        self.n_classes)

        lab_box = labels[..., 0:4]                       # (B,H,W,4)
        lab_cls = labels[..., 4:]                        # (B,H,W,C)
        # a cell holds an object iff its label box has a positive area
        gt_wh = lab_box[..., 2:4] - lab_box[..., 0:2]
        gt_area = gt_wh[..., 0] * gt_wh[..., 1]
        obj = (gt_area > 0).to(f32)                      # (B,H,W)
        gt_center = 0.5 * (lab_box[..., 0:2] + lab_box[..., 2:4])
        gt_xy_in_cell = gt_center - torch.floor(gt_center)

        pred_wh = _anchor_sizes(self.anchors, f32, x.device) \
            * torch.exp(twh)                             # (B,H,W,A,2)

        # predicted corners in grid units: centre = cell index + xy
        cell_x = torch.arange(w, dtype=f32, device=x.device) \
            .view(1, 1, w, 1)
        cell_y = torch.arange(h, dtype=f32, device=x.device) \
            .view(1, h, 1, 1)
        pred_cx = cell_x + txy[..., 0]
        pred_cy = cell_y + txy[..., 1]
        pred_x1 = pred_cx - pred_wh[..., 0] * 0.5
        pred_x2 = pred_cx + pred_wh[..., 0] * 0.5
        pred_y1 = pred_cy - pred_wh[..., 1] * 0.5
        pred_y2 = pred_cy + pred_wh[..., 1] * 0.5

        # IOU against the label's corners (DL4J calculateIOULabelPredicted)
        ix = (torch.minimum(pred_x2, lab_box[..., None, 2])
              - torch.maximum(pred_x1, lab_box[..., None, 0]))
        iy = (torch.minimum(pred_y2, lab_box[..., None, 3])
              - torch.maximum(pred_y1, lab_box[..., None, 1]))
        inter = ix.clamp_min(0.0) * iy.clamp_min(0.0)
        union = (pred_wh[..., 0] * pred_wh[..., 1] + gt_area[..., None]
                 - inter)
        iou = inter / (union + 1e-9)                     # (B,H,W,A)
        responsible = torch.nn.functional.one_hot(
            torch.argmax(iou, dim=-1), n_a).to(f32) * obj[..., None]

        # coordinates: xy SSE within the cell, wh SSE on the square roots
        # of the grid-unit sizes (DL4J Yolo2OutputLayer.java:128,147)
        xy_err = ((txy - gt_xy_in_cell[..., None, :]) ** 2).sum(-1)
        wh_err = ((torch.sqrt(pred_wh.clamp_min(1e-9))
                   - torch.sqrt(gt_wh[..., None, :].clamp_min(1e-9)))
                  ** 2).sum(-1)
        coord_loss = self.lambda_coord * (responsible
                                          * (xy_err + wh_err)).sum()
        # confidence: the IOU where responsible, 0 elsewhere
        conf_obj = (responsible * (conf - iou) ** 2).sum()
        conf_noobj = self.lambda_no_obj * ((1.0 - responsible)
                                           * conf ** 2).sum()
        # classes: SSE of the softmax on the responsible anchors
        probs = torch.softmax(cls_logits, dim=-1)
        cls_err = ((probs - lab_cls[..., None, :]) ** 2).sum(-1)
        cls_loss = (responsible * cls_err).sum()
        total = coord_loss + conf_obj + conf_noobj + cls_loss
        return total / b


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def decode_detections(activated, anchors, n_classes: int,
                      conf_threshold: float = 0.5):
    """Activated YOLO output -> [(boxes (N, 4), scores (N,), classes
    (N,))] per image, boxes as [x1, y1, x2, y2] in grid units, in the
    cells' row-major order then by anchor (DL4J
    Yolo2OutputLayer.getPredictedObjects). Host-side.

    activated: (B, H, W, A*(5+C)) from Yolo2OutputLayer.apply, a tensor
    or an array."""
    act = _host(activated)
    b, h, w, _ = act.shape
    n_a = len(anchors)
    act = act.reshape(b, h, w, n_a, 5 + n_classes)
    results = []
    for i in range(b):
        yy, xx, a = np.nonzero(act[i, ..., 4] >= conf_threshold)
        det = act[i, yy, xx, a].astype(np.float64)        # (N, 5 + C)
        cx = xx + det[:, 0]
        cy = yy + det[:, 1]
        half_w, half_h = det[:, 2] / 2, det[:, 3] / 2
        boxes = np.stack([cx - half_w, cy - half_h, cx + half_w,
                          cy + half_h], axis=-1).reshape(-1, 4)
        results.append((boxes.astype(np.float32),
                        det[:, 4].astype(np.float32),
                        np.argmax(det[:, 5:], axis=-1).astype(np.int32)))
    return results


def non_max_suppression(boxes, scores, classes=None,
                        iou_threshold: float = 0.45):
    """Greedy NMS over decoded boxes (DL4J YoloUtils.nms), host-side: the
    indices kept, best score first. As in DL4J (YoloUtils.java:105-124),
    a box suppresses only boxes of its own class; `classes=None` treats
    all boxes as one class."""
    boxes, scores = np.asarray(boxes), np.asarray(scores)
    if len(boxes) == 0:
        return []
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for idx in order:
        if suppressed[idx]:
            continue
        keep.append(int(idx))
        x1 = np.maximum(boxes[idx, 0], boxes[:, 0])
        y1 = np.maximum(boxes[idx, 1], boxes[:, 1])
        x2 = np.minimum(boxes[idx, 2], boxes[:, 2])
        y2 = np.minimum(boxes[idx, 3], boxes[:, 3])
        inter = np.maximum(0, x2 - x1) * np.maximum(0, y2 - y1)
        iou = inter / (areas[idx] + areas - inter + 1e-9)
        over = iou > iou_threshold
        if classes is not None:
            over &= np.asarray(classes) == classes[idx]
        suppressed |= over
    return keep
