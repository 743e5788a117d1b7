"""Architecture configs. Importing this package registers all of them:
the MadEye detector and the LM half of the model zoo."""
from repro_torch.configs import (  # noqa: F401
    deepseek_v3_671b,
    kimi_k2_1t_a32b,
    madeye_approx,
    stablelm_12b,
    stablelm_3b,
)
from repro_torch.configs.base import (  # noqa: F401
    DetectorConfig,
    LMConfig,
    ShapeSpec,
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
    FAMILY_SHAPES,
    LM_SHAPES,
    get_shape,
    shapes_for,
)

LM_ARCHS = [
    "stablelm-3b",
    "stablelm-12b",
    "deepseek-v3-671b",
    "kimi-k2-1t-a32b",
]
