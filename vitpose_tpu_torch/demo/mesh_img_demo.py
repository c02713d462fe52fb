"""SMPL mesh image demo: a person box -> HMR -> mesh vertices -> a z-buffer
rendering over the image (counterpart of demo/mesh_img_demo.py).

    python -m vitpose_tpu_torch.demo.mesh_img_demo IMG [--config CONFIG]
        [--checkpoint w.pth|.npz] [--bbox x,y,w,h]
        [--out-img-root vis_results] [--device cuda|cpu]

The model is the config's (default the zoo's HMR ResNet-50 at 224x224)
with seeded weights (torch.Generator 0) unless --checkpoint gives them.
The SMPL assets are not in the repository, and the config's linear
surrogate has no faces, so the demo swaps in a low-poly ellipsoid body
with faces (JAX's demo's stand-in: 192 vertices moved by a seeded linear
map of the pose and shape). The rendering is written to
OUT/vis_mesh_<image name>.
"""
import argparse
import os

import numpy as np
import torch

from ..api import init_pose_model
from ..api.inference_3d import inference_mesh_model, vis_3d_mesh_result
from ..data.bottomup import read_rgb
from ..models.mesh import LinearSMPL

CONFIG = os.path.join(os.path.dirname(__file__), '..', '..', 'vitpose_tpu',
                      'configs', 'mesh', 'hmr_res50_mixed_224x224.py')


class EllipsoidSMPL(LinearSMPL):
    """The ellipsoid stand-in: vertices = rest ellipsoid + (pose, shape) @
    W, joints every 8th vertex."""

    def __init__(self):
        n_lat, n_lon = 12, 16
        verts = [[0.3 * np.sin(th) * np.cos(ph), 0.6 * np.cos(th),
                  0.3 * np.sin(th) * np.sin(ph)]
                 for th in np.pi * (np.arange(n_lat) + 0.5) / n_lat
                 for ph in 2 * np.pi * np.arange(n_lon) / n_lon]
        faces = []
        for i in range(n_lat - 1):
            for j in range(n_lon):
                a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
                c, d = a + n_lon, b + n_lon
                faces += [[a, b, c], [b, d, c]]
        rng = np.random.RandomState(0)
        w_v = rng.randn(82, len(verts) * 3).astype(np.float32) * 1e-3
        super().__init__(np.zeros((82, 72), np.float32), w_v)
        self.register_buffer('rest', torch.as_tensor(
            np.asarray(verts, np.float32)), persistent=False)
        self.faces = np.asarray(faces, np.int64)

    def forward(self, pose, shape):
        verts, _ = super().forward(pose, shape)
        verts = verts + self.rest
        return verts, verts[:, ::8][:, :24]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('img')
    ap.add_argument('--config', default=CONFIG)
    ap.add_argument('--checkpoint', default=None)
    ap.add_argument('--bbox', default=None, help='x,y,w,h')
    ap.add_argument('--out-img-root', default='vis_results')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    img = read_rgb(args.img)
    h, w = img.shape[:2]
    box = ([float(v) for v in args.bbox.split(',')] if args.bbox
           else [0, 0, w, h])
    model = init_pose_model(args.config, checkpoint=args.checkpoint,
                            device=args.device)
    body = EllipsoidSMPL().to(next(model.parameters()).device)
    model.smpl = body
    results = inference_mesh_model(model, img, [{'bbox': box}],
                                   faces=body.faces)
    os.makedirs(args.out_img_root, exist_ok=True)
    out = os.path.join(args.out_img_root,
                       'vis_mesh_' + os.path.basename(args.img))
    vis_3d_mesh_result(model, results, img=img, out_file=out)
    print(f'mesh rendered -> {out}')
    return results, out


if __name__ == '__main__':
    main()
