"""Parametric human mesh recovery (HMR) with its adversarial prior, in
PyTorch.

Counterpart of vitpose_tpu/models/mesh.py (reference mmpose
detectors/mesh.py `ParametricMesh`, heads/hmr_head.py `HMRMeshHead`,
misc/discriminator.py `SMPLDiscriminator`):

  * `HMRMeshHead` under mmpose's names: `fc1`, `fc2` (no activation
    between them; JAX's optional dropout, which no caller turns on, is left
    out) and the decoders `decpose`,
    `decshape`, `deccam` (JAX fuses them into one Dense 'out'), iterated
    from the mean parameters, which are the buffers `init_pose`,
    `init_shape`, `init_cam` (JAX's `mean_params` under a stop_gradient):
    no optimizer sees them;
  * `rot6d_to_rotmat`, `rotmat_to_quat` (Shepperd's largest-component
    form) and `rot6d_to_axis_angle`, JAX's arithmetic and branches;
  * `SMPLDiscriminator` under JAX's flax names (JAX converts no reference
    discriminator): per-joint, shape and full-pose logits [N, 25];
  * `ParametricMesh`: the trunk (`backbone`), the spatial mean, the head,
    the axis-angle pose, an SMPL function of (pose, shape) -> (vertices,
    joints) and the weak-perspective projection;
  * `adversarial_step`: one generator and one discriminator update, in
    place (JAX's `make_adversarial_train_step` :244);
  * `LinearSMPL` (JAX's `linear_smpl_fn` :298: the same RandomState draws,
    w_j first) and `npz_smpl` (`npz_smpl_fn`), as non-persistent buffers.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .losses import gan_loss, mesh_joint_loss
from .resnet import init_cnn
from .vit import ViT, compute_dtype, linear

POSE_DIM, SHAPE_DIM, CAM_DIM = 72, 10, 3


class HMRMeshHead(nn.Module):
    """[N, C] features -> (pose [N, pose_dim], shape [N, 10], cam [N, 3])
    by `num_iters` refinements of the mean parameters. pose_dim 144 is
    mmpose's 24 x rot6d layout, 72 the axis-angle one."""

    def __init__(self, in_channels, num_iters=3, hidden=1024,
                 pose_dim=POSE_DIM, dtype='float32', generator=None):
        super().__init__()
        self.num_iters = num_iters
        self.pose_dim = pose_dim
        self.dtype = compute_dtype(dtype)
        npar = pose_dim + SHAPE_DIM + CAM_DIM
        self.fc1 = nn.Linear(in_channels + npar, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.decpose = nn.Linear(hidden, pose_dim)
        self.decshape = nn.Linear(hidden, SHAPE_DIM)
        self.deccam = nn.Linear(hidden, CAM_DIM)
        # mmpose's default without a mean-parameter file: zero pose and
        # shape, cam (1, 0, 0) (hmr_head.py:43-45)
        self.register_buffer('init_pose', torch.zeros(1, pose_dim))
        self.register_buffer('init_shape', torch.zeros(1, SHAPE_DIM))
        self.register_buffer('init_cam', torch.tensor([[1.0, 0.0, 0.0]]))
        init_cnn(self, generator)

    def forward(self, feat):
        dt = self.dtype
        n = feat.shape[0]
        params = torch.cat([self.init_pose, self.init_shape, self.init_cam],
                           dim=1).to(dt).expand(n, -1)
        feat = feat.to(dt)
        for _ in range(self.num_iters):
            x = torch.cat([feat, params], dim=-1)
            x = linear(self.fc2, linear(self.fc1, x, dt), dt)
            delta = torch.cat([linear(self.decpose, x, dt),
                               linear(self.decshape, x, dt),
                               linear(self.deccam, x, dt)], dim=-1)
            params = params + delta
        pd = self.pose_dim
        return (params[:, :pd], params[:, pd:pd + SHAPE_DIM],
                params[:, pd + SHAPE_DIM:])


def rot6d_to_rotmat(x):
    """[N, 24 * 6] rot6d -> [N * 24, 3, 3] rotation matrices (Zhou et al.,
    CVPR 2019: Gram-Schmidt on the two columns)."""
    n = x.shape[0]
    a = x.reshape(n * 24, 3, 2)
    a0, a1 = a[..., 0], a[..., 1]
    b1 = a0 / a0.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    proj = (b1 * a1).sum(-1, keepdim=True)
    b2 = a1 - proj * b1
    b2 = b2 / b2.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    b3 = torch.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_quat(m):
    """[..., 3, 3] rotation matrices -> [..., 4] unit quaternions (w, x, y,
    z), w >= 0: of Shepperd's four forms the one whose leading term is the
    largest (the first of equal ones, as jnp.argmax picks)."""
    d0, d1, d2 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    q0 = torch.stack([1.0 + d0 + d1 + d2, m[..., 2, 1] - m[..., 1, 2],
                      m[..., 0, 2] - m[..., 2, 0],
                      m[..., 1, 0] - m[..., 0, 1]], dim=-1)
    q1 = torch.stack([m[..., 2, 1] - m[..., 1, 2], 1.0 + d0 - d1 - d2,
                      m[..., 0, 1] + m[..., 1, 0],
                      m[..., 0, 2] + m[..., 2, 0]], dim=-1)
    q2 = torch.stack([m[..., 0, 2] - m[..., 2, 0],
                      m[..., 0, 1] + m[..., 1, 0], 1.0 - d0 + d1 - d2,
                      m[..., 1, 2] + m[..., 2, 1]], dim=-1)
    q3 = torch.stack([m[..., 1, 0] - m[..., 0, 1],
                      m[..., 0, 2] + m[..., 2, 0],
                      m[..., 1, 2] + m[..., 2, 1], 1.0 - d0 - d1 + d2],
                     dim=-1)
    lead = torch.stack([q0[..., 0], q1[..., 1], q2[..., 2], q3[..., 3]],
                       dim=-1)
    cand = torch.stack([q0, q1, q2, q3], dim=-2)            # [..., 4, 4]
    idx = lead.argmax(dim=-1)
    q = torch.gather(cand, -2, idx[..., None, None].expand(
        *idx.shape, 1, 4))[..., 0, :]
    q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def rot6d_to_axis_angle(x):
    """[N, 24 * 6] rot6d -> [N, 72] axis-angle through quaternions: angle
    2 atan2(|v|, w), the small-angle limit 2 / w below |v| = 1e-6."""
    n = x.shape[0]
    q = rotmat_to_quat(rot6d_to_rotmat(x))
    w, v = q[..., 0], q[..., 1:]
    vn = v.norm(dim=-1)
    angle = 2.0 * torch.atan2(vn, w)
    scale = torch.where(vn < 1e-6, 2.0 / w.clamp_min(0.5),
                        angle / vn.clamp_min(1e-6))
    return (v * scale[..., None]).reshape(n, 72)


class SMPLDiscriminator(nn.Module):
    """(pose [N, 72] axis-angle, shape [N, 10]) -> [N, 25] realism logits
    (23 joints, shape, full pose), JAX's flax layer names."""

    def __init__(self, hidden=256, dtype='float32', generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.joint_embed = nn.Linear(3, 32)
        self.joint_out = nn.Linear(32, 1)
        self.shape_fc = nn.Linear(SHAPE_DIM, hidden // 4)
        self.shape_out = nn.Linear(hidden // 4, 1)
        self.full_fc = nn.Linear(23 * 32, hidden)
        self.full_out = nn.Linear(hidden, 1)
        init_cnn(self, generator)

    def forward(self, pose, shape):
        dt = self.dtype
        n = pose.shape[0]
        joints = pose.to(dt).reshape(n, 24, 3)[:, 1:]
        common = torch.relu(linear(self.joint_embed, joints, dt))
        per_joint = linear(self.joint_out, common, dt)[..., 0]
        sh = torch.relu(linear(self.shape_fc, shape.to(dt), dt))
        sh = linear(self.shape_out, sh, dt)
        full = torch.relu(linear(self.full_fc, common.reshape(n, -1), dt))
        full = linear(self.full_out, full, dt)
        return torch.cat([per_joint, sh, full], dim=-1)


def project_points(joints_3d, cam):
    """Weak perspective: cam = (scale, tx, ty)."""
    return cam[:, :1, None] * joints_3d[..., :2] + cam[:, None, 1:]


class LinearSMPL(nn.Module):
    """(pose [N, 72], shape [N, 10]) -> (vertices [N, V, 3], joints
    [N, 24, 3]) as fixed linear maps `w_j` [82, 72] and `w_v` [82, V * 3]
    (non-persistent buffers: no checkpoint holds them)."""

    def __init__(self, w_j, w_v):
        super().__init__()
        self.register_buffer('w_j', torch.as_tensor(w_j, dtype=torch.float32),
                             persistent=False)
        self.register_buffer('w_v', torch.as_tensor(w_v, dtype=torch.float32),
                             persistent=False)

    def forward(self, pose, shape):
        n = pose.shape[0]
        params = torch.cat([pose, shape], dim=-1).float()
        joints = (params @ self.w_j.float()).reshape(n, 24, 3)
        verts = (params @ self.w_v.float()).reshape(n, -1, 3)
        return verts, joints


def linear_smpl(seed=0, num_verts=689):
    """The seeded linear SMPL surrogate: numpy RandomState(seed) draws w_j
    then w_v (randn, f32, times 0.01), as JAX's linear_smpl_fn."""
    rng = np.random.RandomState(seed)
    w_j = rng.randn(POSE_DIM + SHAPE_DIM, 24 * 3).astype(np.float32) * 0.01
    w_v = rng.randn(POSE_DIM + SHAPE_DIM,
                    num_verts * 3).astype(np.float32) * 0.01
    return LinearSMPL(w_j, w_v)


def npz_smpl(path):
    """A linearised SMPL basis from an npz with J_w [82, 72] and V_w
    [82, V * 3]."""
    data = np.load(path)
    return LinearSMPL(np.asarray(data['J_w'], np.float32),
                      np.asarray(data['V_w'], np.float32))


class ParametricMesh(nn.Module):
    """The generator: trunk -> spatial mean -> HMR head -> SMPL."""

    def __init__(self, backbone, smpl, num_iters=3, pose_rep='aa',
                 backbone_type='resnet', generator=None):
        """pose_rep 'rot6d' regresses mmpose's 24 x 6 layout and turns it
        into axis-angle before `smpl`; `backbone_type` names the trunk for
        checkpoints."""
        super().__init__()
        self.backbone = backbone
        self.backbone_type = 'vit' if isinstance(backbone, ViT) \
            else backbone_type
        self.pose_rep = pose_rep
        channels = (backbone.cfg.embed_dim if isinstance(backbone, ViT)
                    else backbone.out_channels)
        self.mesh_head = HMRMeshHead(
            channels, num_iters=num_iters,
            pose_dim=144 if pose_rep == 'rot6d' else POSE_DIM,
            generator=generator)
        self.smpl = smpl

    def forward(self, imgs):
        """[N, H, W, 3] crops -> dict(pose (axis-angle), shape, cam,
        vertices, joints_3d, joints_2d)."""
        feat = self.backbone(imgs)
        feat = (feat.mean(dim=(1, 2)) if isinstance(self.backbone, ViT)
                else feat.mean(dim=(2, 3)))
        pose, shape, cam = self.mesh_head(feat)
        if self.pose_rep == 'rot6d':
            pose = rot6d_to_axis_angle(pose)
        verts, joints3d = self.smpl(pose, shape)
        return dict(pose=pose, shape=shape, cam=cam, vertices=verts,
                    joints_3d=joints3d,
                    joints_2d=project_points(joints3d, cam))


def _grads_to(loss, params):
    """`loss`'s gradient into each parameter's `.grad` (zeros where it does
    not reach), leaving every other tensor's `.grad` untouched."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g


def adversarial_step(mesh, disc, gen_opt, disc_opt, batch, w_joint2d=1.0,
                     w_joint3d=1.0, w_adv=0.1, w_disc=1.0, gen_sched=None,
                     disc_sched=None):
    """One generator and one discriminator update in place (JAX
    make_adversarial_train_step): the training-mode forward (BN statistics
    move in place, as JAX merges them after the update), the 2D and
    hip-centred 3D L1 losses and the LSGAN term through the discriminator
    as it is, the generator's update; then the discriminator's LSGAN loss
    on the real parameters and on the generator's outputs of this forward,
    detached, and its update. Returns the losses (tensors)."""
    mesh.train()
    disc.train()
    out = mesh(batch['imgs'])
    l2d = mesh_joint_loss(out['joints_2d'], batch['joints_2d'],
                          batch['joints_2d_visible']) * w_joint2d
    l3d = mesh_joint_loss(out['joints_3d'], batch['joints_3d'],
                          batch['joints_3d_visible'],
                          pelvis_ids=(2, 3)) * w_joint3d
    ladv = gan_loss(disc(out['pose'], out['shape']), True, 'lsgan') * w_adv
    gl = l2d + l3d + ladv
    gen_params = [p for p in mesh.parameters() if p.requires_grad]
    _grads_to(gl, gen_params)
    gen_opt.step()
    if gen_sched is not None:
        gen_sched.step()
    fake = disc(out['pose'].detach(), out['shape'].detach())
    real = disc(batch['real_pose'], batch['real_shape'])
    dl = (gan_loss(real, True, 'lsgan')
          + gan_loss(fake, False, 'lsgan')) * w_disc
    _grads_to(dl, [p for p in disc.parameters() if p.requires_grad])
    disc_opt.step()
    if disc_sched is not None:
        disc_sched.step()
    return dict(loss_2d=l2d.detach(), loss_3d=l3d.detach(),
                loss_adv=ladv.detach(), gen_loss=gl.detach(),
                disc_loss=dl.detach())


def build_parametric_mesh(mcfg: dict, build_backbone, generator=None):
    """A config's `model` dict -> ParametricMesh (reference ParametricMesh
    detector, mesh.py:24): `backbone_type` (default 'resnet') with its
    overrides from `build_backbone`, `smpl` an .npz basis or the seeded
    linear surrogate, `num_iters`, `pose_rep`."""
    mcfg = dict(mcfg)
    mcfg.pop('family', None)
    backbone_type = mcfg.pop('backbone_type', 'resnet')
    bb = build_backbone(backbone_type, generator,
                        **(mcfg.pop('backbone_overrides', None) or {}))
    smpl = mcfg.pop('smpl', 'linear')
    smpl_mod = (npz_smpl(smpl) if isinstance(smpl, str)
                and smpl.endswith('.npz') else linear_smpl())
    return ParametricMesh(bb, smpl_mod, num_iters=mcfg.pop('num_iters', 3),
                          pose_rep=mcfg.pop('pose_rep', 'aa'),
                          backbone_type=backbone_type, generator=generator)
