"""Model configuration for the PyTorch port.

The port's own copy of ``repro.configs.base``: the same frozen dataclass
with the same fields and defaults (full configs in bfloat16, reduced
variants in float32), so a config built here compares field for field
with the JAX package's. Only the architectures this slice serves are
registered in ``ARCH_IDS``.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Tuple

# Block kinds (the JAX package's models/blocks.py names)
ATTN = "attn"
LOCAL_ATTN = "local_attn"
RGLRU = "rglru"
RWKV = "rwkv"

VALID_BLOCKS = (ATTN, LOCAL_ATTN, RGLRU, RWKV)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (exact published values in configs/<id>.py)."""

    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                   # query heads (0 for attention-free archs)
    n_kv_heads: int                # KV heads (GQA); == n_heads means MHA
    d_ff: int                      # dense-FFN hidden width
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0              # expert hidden width (0 -> d_ff)
    moe_cf: float = 1.25           # expert capacity factor (per-row dispatch)

    # --- attention details ---
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0        # 0 -> no sliding window on LOCAL_ATTN/ATTN
    causal: bool = True            # False for encoder-only (hubert)
    logits_softcap: float = 0.0

    # --- block pattern (repeated; remainder layers reuse the prefix) ---
    block_pattern: Tuple[str, ...] = (ATTN,)

    # --- FFN ---
    activation: str = "swiglu"     # swiglu | geglu | gelu | relu2 | silu

    # --- positional encoding ---
    rope: str = "rope"             # rope | mrope | none
    rope_theta: float = 10000.0

    # --- embeddings / norm ---
    tie_embeddings: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm

    # --- RWKV specifics ---
    rwkv_head_dim: int = 64

    # --- RG-LRU specifics ---
    rglru_width: int = 0           # recurrence width (0 -> d_model)
    conv1d_width: int = 4          # temporal conv in recurrent block

    # --- modality frontend stubs ---
    frontend: str = "none"         # none | audio_frames | vision_patches
    frontend_seq: int = 0          # patches/frames per sample for stub inputs

    # --- numerics / compile strategy ---
    dtype: str = "bfloat16"
    scan_layers: bool = True       # JAX layer scan; the port loops in Python
    remat: str = "dots"            # none | dots | full

    # --- provenance ---
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.moe_d_ff == 0 and self.n_experts > 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.rglru_width == 0:
            object.__setattr__(self, "rglru_width", self.d_model)
        for b in self.block_pattern:
            if b not in VALID_BLOCKS:
                raise ValueError(f"unknown block kind {b!r}")

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, repeating ``block_pattern`` with remainder."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def with_overrides(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


#: architectures the port serves so far (later slices add the rest)
ARCH_IDS = ("qwen3_1_7b",)


def _module(arch_id: str):
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS:
        raise ValueError(f"architecture {arch_id!r} is not ported yet; "
                         f"the port serves {list(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ModelConfig:
    """Load the full published config for a ported architecture."""
    return _module(arch_id).CONFIG


def get_reduced_config(arch_id: str) -> ModelConfig:
    """Load the reduced same-family smoke config, in float32 (CPU test
    numerics); full configs keep their production dtype (bfloat16)."""
    return _module(arch_id).reduced().with_overrides(dtype="float32")
