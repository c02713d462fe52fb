"""HTTP pose server of the port.

    python -m vitpose_tpu_torch.tools.serve [--variant s] [--config FILE]
        [--checkpoint CKPT] [--port 8080] [--host 127.0.0.1] [--fast]
        [--int8] [--int8-qkv] [--calib-dir DIR] [--device cuda|cpu]

Counterpart of tools/deployment/serve.py, with the same endpoints, flags
and defaults, plus `--device` (CUDA by default; it raises without CUDA):

  POST /predict {"image": "<base64 jpeg/png>",
                 "bboxes": [[x, y, w, h, score], ...]}
       -> {"pose_results": [{"bbox": [...], "keypoints": [[x, y, s] x K]}]}
       (no boxes: one box over the whole image; a bad body: 400)
  GET  /health -> status, model, input_size, num_joints, dataset

A CNN config (ResNet, ResNetV1d, HRNet, HRNetV2) serves its own model;
`--fast` and `--int8` then print a note and are ignored, as in JAX.
`--fast` serves in bf16 with K1 attention and tanh GELU. `--int8` runs the
MLP products W8A8 at static scales calibrated on `_calibration_batches`
(`--calib-dir` images, else seeded synthetic ones); `--int8-qkv` quantises
attention's qkv and proj too and implies `--int8`. One request at a time,
as in the JAX server: no batching across requests. `build_server` returns
the bound server, so that a caller can bind port 0 and shut it down.
"""
from __future__ import annotations

import argparse
import base64
import dataclasses
import glob
import json
import os
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

from ..api.inference import inference_top_down_pose_model, init_pose_model
from ..data.dataset_info import DatasetInfo
from ..data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from ..models.topdown import make_config
from ..train.loop import topdown_config
from ..utils.config import load_config
from ..utils.quantize import (calibrate_act_scales, int8_serving_config,
                              rebuild)


def make_handler(model):
    import cv2

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path == '/health':
                ih, iw = model.cfg.backbone.img_size
                self._json(200, {
                    'status': 'ok',
                    'model': 'vitpose_tpu_torch',
                    'input_size': [ih, iw],
                    'num_joints': model.cfg.out_channels,
                    'dataset': model.dataset_info.dataset_name,
                })
            else:
                self._json(404, {'error': 'not found'})

        def do_POST(self):
            if self.path != '/predict':
                self._json(404, {'error': 'not found'})
                return
            try:
                length = int(self.headers.get('Content-Length', 0))
                req = json.loads(self.rfile.read(length))
                raw = base64.b64decode(req['image'])
                img = cv2.imdecode(np.frombuffer(raw, np.uint8),
                                   cv2.IMREAD_COLOR)
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
                person_results = ([{'bbox': np.asarray(b, np.float32)}
                                   for b in req.get('bboxes', [])]
                                  or None)
                results, _ = inference_top_down_pose_model(
                    model, img, person_results)
                out = [{'bbox': np.asarray(r.get('bbox', [])).tolist(),
                        'keypoints': np.asarray(r['keypoints']).tolist()}
                       for r in results]
                self._json(200, {'pose_results': out})
            except Exception as e:                      # noqa: BLE001
                # the request's fault or the model's: the client gets the
                # message, and the server goes on serving
                self._json(400, {'error': str(e)})

    return Handler


def _calibration_batches(calib_dir, ih, iw, n=16):
    """Inputs for int8 activation calibration: the normalised images of
    `calib_dir` (up to n, resized to the crop size) when it holds any, else
    two batches of 8 uniform [0, 1) images from RandomState(0), normalised
    as the serving path normalises crops."""
    def norm(x01):
        return ((x01 - np.asarray(IMAGENET_MEAN, np.float32))
                / np.asarray(IMAGENET_STD, np.float32))

    if calib_dir:
        import cv2
        paths = sorted(
            p for ext in ('jpg', 'jpeg', 'png')
            for p in glob.glob(os.path.join(calib_dir, f'*.{ext}')))[:n]
        if paths:
            imgs = []
            for p in paths:
                img = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
                img = cv2.resize(img, (iw, ih))
                imgs.append(img.astype(np.float32) / 255.0)
            return [norm(np.stack(imgs))]
        print(f'no images found in {calib_dir}; falling back to '
              'synthetic calibration inputs', flush=True)
    else:
        print('int8 calibration on synthetic inputs; pass --calib-dir '
              'with representative images for best accuracy', flush=True)
    rng = np.random.RandomState(0)
    return [norm(rng.rand(8, ih, iw, 3).astype(np.float32))
            for _ in range(2)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description='HTTP pose server (PyTorch '
                                 'port)')
    ap.add_argument('--variant', default='s')
    ap.add_argument('--checkpoint', default=None)
    ap.add_argument('--port', type=int, default=8080)
    ap.add_argument('--host', default='127.0.0.1',
                    help='bind address (0.0.0.0 to expose beyond the '
                         'host/container)')
    ap.add_argument('--config', default=None,
                    help='optional config file (overrides --variant)')
    ap.add_argument('--fast', action='store_true',
                    help='serving-time math: bf16 + K1 attention + tanh '
                         'GELU')
    ap.add_argument('--int8', action='store_true',
                    help='additionally run the MLP products W8A8 with '
                         'calibrated static scales (utils/quantize.py)')
    ap.add_argument('--int8-qkv', action='store_true',
                    help='also quantize attention qkv/proj (implies --int8)')
    ap.add_argument('--calib-dir', default=None,
                    help='directory of representative images for int8 '
                         'activation calibration (without it calibration '
                         'uses synthetic inputs and accuracy may degrade)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)
    args.int8 = args.int8 or args.int8_qkv
    return args


def build_model(args):
    """The PoseModel the server runs, built from the parsed flags. A CNN
    config (a single-stage backbone of `train.loop.build_backbone`) serves its
    GenericTopDown; `--fast` and `--int8` are ViT options and are ignored
    for it, with JAX's notes (tools/deployment/serve.py:163-207)."""
    backbone_type = 'vit'
    if args.config:
        file_cfg = load_config(args.config)
        backbone_type = file_cfg['model'].get('backbone_type', 'vit')
        model_cfg = topdown_config(file_cfg['model'])
    else:
        model_cfg = make_config(args.variant, img_size=(256, 192),
                                out_channels=17)
    if args.fast and backbone_type == 'vit':
        model_cfg = dataclasses.replace(
            model_cfg, backbone=dataclasses.replace(
                model_cfg.backbone, dtype='bfloat16', fused_attention=True,
                gelu_approx=True))
    elif args.fast:
        print('--fast (bf16 + K1 attention + tanh GELU) is a ViT-path '
              'option; ignored for CNN backbones', flush=True)
    model = init_pose_model(model_cfg if backbone_type == 'vit'
                            else file_cfg['model'],
                            checkpoint=args.checkpoint, device=args.device)
    if args.config:
        # the config's dataset gives the flip pairs and the metadata
        model.dataset_info = DatasetInfo.load(
            file_cfg['data'].get('dataset', 'coco'))
    if args.int8 and backbone_type != 'vit':
        print('--int8 targets the ViT serving path; ignored for CNN '
              'backbones', flush=True)
    elif args.int8:
        ih, iw = model_cfg.backbone.img_size
        cal = _calibration_batches(args.calib_dir, ih, iw)
        scales = calibrate_act_scales(model.model, cal, attn=args.int8_qkv)
        model.cfg = int8_serving_config(model_cfg, scales, qkv=args.int8_qkv)
        model.model = rebuild(model.model, model.cfg)
    return model


def build_server(argv=None) -> HTTPServer:
    """The server for the command line `argv`, bound and not yet serving;
    its PoseModel is `server.pose_model`."""
    args = parse_args(argv)
    model = build_model(args)
    server = HTTPServer((args.host, args.port), make_handler(model))
    server.pose_model = model
    return server


def main(argv=None):
    server = build_server(argv)
    host, port = server.server_address[:2]
    print(f'serving on http://{host}:{port} (POST /predict, GET /health)',
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == '__main__':
    main()
