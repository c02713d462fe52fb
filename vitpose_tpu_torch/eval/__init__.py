"""Evaluation of the port: COCO keypoint AP on the host, and the val loop
that runs the model on its device."""
from .cocoeval import (COCO_KPT_STAT_NAMES, CocoKeypointEval,
                       evaluate_crowdpose)
from .loop import make_val_step, run_validation
