"""User-facing inference API of the port."""
from .inference import (PoseModel, inference_top_down_pose_model,
                        init_pose_model, load_checkpoint)
