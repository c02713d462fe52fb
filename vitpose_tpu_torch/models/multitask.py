"""One trunk, several heads: the multi-task model, in PyTorch.

Counterpart of vitpose_tpu/models/multitask.py (`MultiTaskModel`,
`multitask_loss`; reference mmpose detectors/multi_task.py): a shared
backbone feeds a list of heads; the training loss is the (weighted) sum of
each head's loss. The heads take the backbone's features as they come and
the module's mode is theirs (BN statistics move in training mode). The
heads take NHWC features, as JAX's do: a CNN trunk's NCHW map goes to them
as a permuted view, a ViT's as it is.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch.nn as nn

from .vit import ViT


class MultiTaskModel(nn.Module):
    def __init__(self, backbone: nn.Module, heads: Sequence[nn.Module]):
        super().__init__()
        self.backbone = backbone
        self.heads = nn.ModuleList(heads)

    def forward(self, x, **backbone_kw):
        """[N, H, W, 3] -> a list with each head's output."""
        feat = self.backbone(x, **backbone_kw)
        if not isinstance(self.backbone, ViT):
            feat = feat.permute(0, 2, 3, 1)
        return [head(feat) for head in self.heads]


def multitask_loss(outputs: List, targets: List, target_weights: List,
                   loss_fns: List[Callable], loss_weights=None):
    """(total, {'loss_head_i': ..., 'total_loss': total}): each head's
    loss_fns[i](output, target, weight), times loss_weights[i] when
    given."""
    total = 0.0
    losses = {}
    for i, (out, tgt, w, fn) in enumerate(zip(outputs, targets,
                                              target_weights, loss_fns)):
        li = fn(out, tgt, w)
        if loss_weights is not None:
            li = li * loss_weights[i]
        losses[f'loss_head_{i}'] = li
        total = total + li
    losses['total_loss'] = total
    return total, losses
