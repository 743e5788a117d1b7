"""Config dataclasses and the registry of architectures.

Every architecture module in this package registers its FULL config
(the published numbers) and a SMOKE config (the same family at tiny
widths, what the CPU tests run). The fields, defaults and numbers are
the JAX package's; `dtype` is a torch dtype here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch


@dataclass(frozen=True)
class LMConfig:
    """A decoder-only LM: dense (StableLM) or MoE with MLA or GQA
    attention (DeepSeek-V3, Kimi-K2)."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    max_seq: int = 8192
    rope_theta: float = 10000.0
    # MoE (None => dense)
    moe_experts: Optional[int] = None
    moe_top_k: int = 8
    moe_shared_experts: int = 0
    moe_d_ff: Optional[int] = None          # per-expert hidden dim
    first_dense_layers: int = 0     # e.g. deepseek: first k layers dense
    # MLA (False => GQA)
    mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # numerics
    dtype: Any = torch.bfloat16
    # activation rematerialization: with grad on, each layer is
    # recomputed in the backward pass (models/layers.remat)
    remat: bool = True
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def family(self) -> str:
        return "lm"


@dataclass(frozen=True)
class VisionConfig:
    """An image classifier: ViT (S/16, B/16, H/14) or Swin (swin=True,
    with per-stage depths and dims)."""
    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int = 1000
    # Swin-specific
    swin: bool = False
    window: int = 7
    depths: tuple = ()
    dims: tuple = ()
    dtype: Any = torch.bfloat16
    # activation rematerialization: with grad on, each layer is
    # recomputed in the backward pass (models/layers.remat)
    remat: bool = False

    @property
    def family(self) -> str:
        return "vision"


@dataclass(frozen=True)
class DiffusionConfig:
    """A latent diffusion backbone: DiT (n_layers > 0, DDPM) or a
    Flux-style MMDiT (double and single blocks, rectified flow)."""
    name: str
    img_res: int
    patch: int = 2
    latent_channels: int = 4
    n_layers: int = 0                # DiT
    n_double_blocks: int = 0         # MMDiT
    n_single_blocks: int = 0
    d_model: int = 1024
    n_heads: int = 16
    latent_res: Optional[int] = None  # flux operates on latents
    cond_dim: int = 768              # text/conditioning embedding width (stub)
    n_classes: int = 1000            # DiT class conditioning
    dtype: Any = torch.bfloat16
    remat: bool = True

    @property
    def family(self) -> str:
        return "diffusion"

    @property
    def is_mmdit(self) -> bool:
        return self.n_double_blocks > 0


@dataclass(frozen=True)
class DetectorConfig:
    """A backbone + anchor-free detection heads; float32. The backbone
    is a light ViT (n_layers, d_model, n_heads, d_ff) unless `swin`
    holds a Swin VisionConfig (its img_res and patch are the detector's;
    the neck reads its last two stages)."""
    name: str
    img_res: int
    patch: int
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    d_ff: int = 0
    n_classes: int = 2               # {person, car}
    max_boxes: int = 32              # static box budget per frame
    fpn_dim: int = 128
    swin: Optional[VisionConfig] = None

    def __post_init__(self):
        s = self.swin
        if s is None:
            if min(self.n_layers, self.d_model, self.n_heads,
                   self.d_ff) <= 0:
                raise ValueError(f"{self.name}: a ViT backbone needs "
                                 f"n_layers, d_model, n_heads and d_ff")
            return
        if not (s.swin and len(s.dims) == len(s.depths) >= 2
                and (s.img_res, s.patch) == (self.img_res, self.patch)
                and s.dtype == torch.float32
                and self.n_layers == self.d_model == self.n_heads
                == self.d_ff == 0):
            raise ValueError(
                f"{self.name}: a Swin backbone is a float32 Swin "
                f"VisionConfig of >= 2 stages at the detector's img_res "
                f"and patch, with no ViT widths beside it; got {s}")

    @property
    def family(self) -> str:
        return "detector"


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell for an architecture family."""
    name: str
    kind: str         # train | prefill | decode | generate | serve
    seq_len: int = 0
    global_batch: int = 0
    img_res: int = 0
    steps: int = 0


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Any] = {}
_SMOKE: dict[str, Any] = {}


def register(cfg, smoke=None):
    _REGISTRY[cfg.name] = cfg
    if smoke is not None:
        _SMOKE[cfg.name] = smoke
    return cfg


def _load_all() -> None:
    import repro_torch.configs  # noqa: F401  (registers every module)


def get_config(name: str):
    """Full-width config by name."""
    if name not in _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def get_smoke_config(name: str):
    """Same family at smoke widths (what the CPU tests run)."""
    if name not in _SMOKE:
        _load_all()
    return _SMOKE[name]


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)
