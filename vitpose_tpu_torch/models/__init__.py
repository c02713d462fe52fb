"""Models of the port: the plain ViT, the classic deconv head, the
top-down estimator and its loss."""
from .heads import HeatmapHead
from .losses import joints_mse_loss
from .topdown import (TopDownConfig, TopDownModel, forward, infer, loss_fn,
                      make_config)
from .vit import VIT_VARIANTS, Attention, Block, Mlp, ViT, ViTConfig
