"""Architecture configs. Importing this package registers all of them:
the MadEye detector and the model zoo (LMs, vision, diffusion)."""
from repro_torch.configs import (  # noqa: F401
    deepseek_v3_671b,
    dit_l2,
    flux_dev,
    kimi_k2_1t_a32b,
    madeye_approx,
    stablelm_12b,
    stablelm_3b,
    swin_b,
    vit_b16,
    vit_h14,
    vit_s16,
)
from repro_torch.configs.base import (  # noqa: F401
    DetectorConfig,
    DiffusionConfig,
    LMConfig,
    ShapeSpec,
    VisionConfig,
    get_config,
    get_smoke_config,
    list_archs,
    register,
)
from repro_torch.configs.madeye_approx import (  # noqa: F401
    MADEYE_APPROX,
    MADEYE_APPROX_SMOKE,
)
from repro_torch.configs.shapes import (  # noqa: F401
    DIFFUSION_SHAPES,
    FAMILY_SHAPES,
    LM_SHAPES,
    VISION_SHAPES,
    get_shape,
    shapes_for,
)

LM_ARCHS = [
    "stablelm-3b",
    "stablelm-12b",
    "deepseek-v3-671b",
    "kimi-k2-1t-a32b",
]

# the reference's order (src/repro/configs/__init__.py)
ASSIGNED_ARCHS = [
    "kimi-k2-1t-a32b",
    "deepseek-v3-671b",
    "stablelm-12b",
    "stablelm-3b",
    "flux-dev",
    "dit-l2",
    "vit-b16",
    "swin-b",
    "vit-h14",
    "vit-s16",
]
