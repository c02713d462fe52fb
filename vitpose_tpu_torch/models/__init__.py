"""Models of the port: the plain ViT, the classic deconv head and the
top-down estimator."""
from .heads import HeatmapHead
from .topdown import TopDownConfig, TopDownModel, forward, infer, make_config
from .vit import VIT_VARIANTS, Attention, Block, Mlp, ViT, ViTConfig
