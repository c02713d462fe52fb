"""COCO segmentation masks (polygons and RLE) for the bottom-up loss mask,
without pycocotools.

The port's own copy of vitpose_tpu/data/mask.py. Crowd regions and people
without keypoints are masked out of the bottom-up heatmap loss (reference:
the bottom-up datasets build `mask` from the annotations' segmentations).
Supports:
  * polygon lists -> cv2.fillPoly rasterization,
  * uncompressed RLE ({'counts': [..], 'size': [h, w]}),
  * COCO compressed RLE strings (the LEB128-style ascii encoding).
`mask_to_rle` and `encode_compressed_rle`, the inverses, write annotations
of synthetic sets.
"""
from __future__ import annotations

from typing import List, Union

import numpy as np


def decode_compressed_rle(s: Union[str, bytes]) -> List[int]:
    """COCO compressed RLE string -> counts list (column-major runs)."""
    if isinstance(s, str):
        s = s.encode()
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
        # sign-extend
        if x & (1 << (5 * k - 1)):
            x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_to_mask(counts, size) -> np.ndarray:
    """Column-major run lengths -> [h, w] uint8 mask."""
    h, w = size
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape(w, h).T                       # column-major


def segmentation_to_mask(segm, height, width) -> np.ndarray:
    """Any COCO segmentation format -> [h, w] uint8 mask."""
    if isinstance(segm, list):                        # polygons
        import cv2
        mask = np.zeros((height, width), np.uint8)
        for poly in segm:
            pts = np.asarray(poly, np.float64).reshape(-1, 2)
            cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
        return mask
    counts = segm['counts']
    if isinstance(counts, (str, bytes)):
        counts = decode_compressed_rle(counts)
    return rle_to_mask(counts, segm['size'])


def mask_to_rle(mask) -> dict:
    """[h, w] mask -> uncompressed RLE {'counts', 'size'} (column-major runs,
    the first one of zeros): the inverse of `rle_to_mask`."""
    mask = np.asarray(mask)
    flat = (mask.T.reshape(-1) > 0).astype(np.int8)
    edges = np.flatnonzero(np.diff(np.concatenate([[0], flat, [2]])))
    runs = np.diff(np.concatenate([[0], edges]))
    counts = [int(c) for c in runs if c]
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    return {'counts': counts, 'size': list(mask.shape)}


def encode_compressed_rle(counts) -> str:
    """Run lengths -> the COCO compressed RLE string: the inverse of
    `decode_compressed_rle` (pycocotools rleToString)."""
    out = []
    for i, x in enumerate(counts):
        x = int(x) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | (0x20 if more else 0)) + 48))
    return ''.join(out)
