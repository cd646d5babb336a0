"""Training losses of the port: label assignment, focal loss, criterion."""
from .assign import (assign_frame, assignment_cost, dynamic_k_assign,
                     dynamic_k_frame, lane_iou_aligned, line_iou_aligned,
                     line_iou_pairwise, train_assign)
from .criterion import LaneCriterion
from .focal import softmax_focal_loss

__all__ = ["assign_frame", "assignment_cost", "dynamic_k_assign",
           "dynamic_k_frame", "lane_iou_aligned",
           "line_iou_aligned", "line_iou_pairwise", "train_assign",
           "LaneCriterion", "softmax_focal_loss"]
