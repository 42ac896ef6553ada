"""Explainability of the port: attention rollout, Grad-CAM++ on the last
block's norm1 tap, and the KAN head's figures."""
from rovit_kan_tpu_torch.explainability.attention_maps import (  # noqa: F401
    ViTAttentionRollout,
    attention_rollout,
)
from rovit_kan_tpu_torch.explainability.gradcam import (  # noqa: F401
    GradCAMPlusPlus,
    gradcam_plus_plus,
)
from rovit_kan_tpu_torch.explainability.kan_viz import (  # noqa: F401
    KANVisualizer,
)
