"""COCO keypoint evaluation of a result json against a ground-truth json.

    python -m vitpose_tpu_torch.tools.eval_detector GT.json RESULTS.json

The port's copy of the JAX package's tools/eval_detector.py (the fork's
eval_detector.py, without xtcocotools): the host COCO index and keypoint
evaluation of `eval/cocoeval.py`, with COCO's OKS sigmas for 17 joints and
the evaluator's default otherwise; prints the stats, rounded to 4 places,
as JSON.
"""
from __future__ import annotations

import argparse
import json

from ..data import CocoIndex
from ..data.dataset_info import DatasetInfo
from ..eval import CocoKeypointEval


def main(argv=None):
    """Evaluate; returns the stats dict (unrounded)."""
    ap = argparse.ArgumentParser(description='COCO keypoint AP of a result '
                                 'json (PyTorch port)')
    ap.add_argument('gt')
    ap.add_argument('results')
    args = ap.parse_args(argv)
    gt = CocoIndex(args.gt)
    dt = gt.loadRes(args.results)
    sigmas = DatasetInfo.load('coco').sigmas
    k = (len(gt.loadAnns(gt.getAnnIds())[0].get('keypoints', [])) // 3
         if gt.dataset.get('annotations') else 17)
    stats = CocoKeypointEval(
        gt, sigmas=sigmas if k == 17 else None).evaluate(dt)
    print(json.dumps({name: round(float(v), 4)
                      for name, v in stats.items()}, indent=2))
    return stats


if __name__ == '__main__':
    main()
