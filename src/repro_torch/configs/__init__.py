"""Architecture configs — one module per architecture (the published
configs, ``source`` noted per file) plus the shape grid.

Counterpart of ``repro.configs``: ``get_config(name)`` resolves an arch id
(dashes ok) to its :class:`ArchConfig`; :func:`reduced` produces the
family-preserving smoke-test config; :func:`input_specs` gives one
step's batch as meta-device tensors (shapes and types, no storage), as
``launch.cell.build_cell`` needs them; the dry run
(``repro_torch.launch.dryrun``) runs a cell on fake tensors of those
shapes, placed on a production mesh, and prices it.  The directory
also holds ``stencils/*.c``, the paper's listings, which the C frontend
resolves by path.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import ClassVar

import torch

from ..models.mamba2 import SSMConfig
from ..models.moe import MoEConfig


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims [arXiv:2412.19437]."""
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    act: str = "swiglu"
    norm: str = "rmsnorm"
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    emb_scale: bool = False        # gemma: embeddings scaled by sqrt(d)
    moe: MoEConfig | None = None
    moe_every: int = 1             # llama4: MoE on every 2nd layer
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    tp: int = 16                   # model-axis size heads are padded to
    local_window: int = 0          # llama4 iRoPE chunked-local attention
    local_period: int = 4          # every `period`-th layer is global/NoPE
    n_dense_layers: int = 0        # deepseek: leading dense-FFN layers
    d_ff_dense: int = 0            # FFN width of interleaved dense layers
    hybrid_attn_every: int = 0     # zamba2: shared attn every k-th block
    encdec: bool = False
    n_enc_layers: int = 0
    enc_len: int = 0               # encoder sequence length (whisper: 1500)
    mtp: bool = False              # deepseek multi-token-prediction head
    act_dtype: str = "bfloat16"    # activation/KV-cache dtype
    n_img_tokens: int = 0          # pixtral: stubbed patch-embedding count
    zero_inference: bool = False   # shard weights over `data` when serving
    source: str = ""
    # Zamba2 as published: fields of PublishedHybridConfig, which every
    # other config (and the JAX package's, field for field) has not
    hybrid_layer_ids: ClassVar[tuple[int, ...]] = ()
    n_mem_blocks: ClassVar[int] = 0
    adapter_rank: ClassVar[int] = 0
    norm_eps: ClassVar[float] = 1e-6

    def __new__(cls, *args, **kw):
        """A config given any of :class:`PublishedHybridConfig`'s own
        fields is one."""
        if cls is ArchConfig and not PUBLISHED_HYBRID.isdisjoint(kw):
            cls = PublishedHybridConfig
        return super().__new__(cls)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------------
    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell."""
        return self.family in ("ssm", "hybrid") or self.local_window > 0

    def supports(self, shape: "ShapeSpec") -> bool:
        if shape.long and not self.subquadratic:
            return False
        return True

    def param_count(self) -> int:
        """Analytic parameter count, from the port's own record tree."""
        from ..models.common import leaves
        from ..models.lm import LM
        return sum(r.numel for r in leaves(LM(self).param_recs()))

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k + shared experts)."""
        if not self.moe:
            return self.param_count()
        m = self.moe
        per_expert = 3 * self.d_model * m.d_ff_expert
        inactive = per_expert * (m.n_experts - m.top_k) * self._n_moe_layers()
        return self.param_count() - inactive

    def _n_moe_layers(self) -> int:
        if not self.moe:
            return 0
        if self.moe_every > 1:
            return self.n_layers // self.moe_every
        return self.n_layers - self.n_dense_layers


@dataclasses.dataclass(frozen=True)
class PublishedHybridConfig(ArchConfig):
    """Zamba2 as published (``models/lm.py``): before each Mamba layer in
    ``hybrid_layer_ids``, the next of ``n_mem_blocks`` weight-shared
    attention+MLP blocks (in turn) over concat(hidden, embedding), its MLP
    with a rank ``adapter_rank`` adapter and a linear of each invocation's
    own, added to that layer's input; RMS norms at ``norm_eps``."""
    hybrid_layer_ids: tuple[int, ...] = ()
    n_mem_blocks: int = 0
    adapter_rank: int = 0
    norm_eps: float = 1e-6

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "hybrid_layer_ids",
                           tuple(self.hybrid_layer_ids))


PUBLISHED_HYBRID = frozenset(
    f.name for f in dataclasses.fields(PublishedHybridConfig)) - frozenset(
    f.name for f in dataclasses.fields(ArchConfig))


# ----------------------------------------------------------------------
# The shape grid (seq_len × global_batch)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                      # train | prefill | decode
    seq: int
    batch: int
    long: bool = False


SHAPES: dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeSpec("long_500k", "decode", 524_288, 1, long=True),
}

ARCH_IDS = [
    "llama4-maverick-400b-a17b",
    "deepseek-v3-671b",
    "mamba2-2.7b",
    "pixtral-12b",
    "zamba2-7b",
    "granite-8b",
    "qwen1.5-110b",
    "phi3-mini-3.8b",
    "gemma-7b",
    "whisper-small",
]


def _modname(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"{__name__}.{_modname(arch)}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def cells() -> list[tuple[str, str]]:
    """All runnable (arch × shape) cells."""
    return [(a, s) for a in ARCH_IDS for s, spec in SHAPES.items()
            if get_config(a).supports(spec)]


# ----------------------------------------------------------------------
# Reduced configs for smoke tests (family-preserving)
# ----------------------------------------------------------------------
def reduced(cfg: ArchConfig) -> ArchConfig:
    kw: dict = dict(
        d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
        vocab=512, tp=1, emb_scale=cfg.emb_scale)
    if cfg.local_window:                      # llama4: keep the 3+1 pattern
        kw.update(n_layers=cfg.local_period, local_window=64)
    elif cfg.hybrid_attn_every:               # zamba2: keep hybrid grouping
        kw.update(n_layers=7, hybrid_attn_every=3, n_kv_heads=4)
    elif cfg.family == "ssm":
        kw.update(n_layers=2)
    elif cfg.encdec:
        kw.update(n_layers=2, n_enc_layers=2, enc_len=16, n_kv_heads=4)
    elif cfg.n_dense_layers:                  # deepseek: 1 dense + 2 moe
        kw.update(n_layers=3, n_dense_layers=1)
    else:
        kw.update(n_layers=2)
    if cfg.moe:
        # capacity_factor = E/k routes the reduced configs droplessly:
        # static-capacity drops depend on the tokens in the call, which
        # would break prefill/decode == forward
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=4,
                                        top_k=min(cfg.moe.top_k, 2),
                                        d_ff_expert=128,
                                        n_shared=min(cfg.moe.n_shared, 1),
                                        capacity_factor=4 / min(
                                            cfg.moe.top_k, 2))
    if cfg.mla:
        kw["mla"] = MLAConfig(q_lora=64, kv_lora=32, qk_nope_dim=32,
                              qk_rope_dim=16, v_dim=32)
        # fp32 activations: MLA decode's absorbed contraction order drifts
        # from the expanded prefill form in bf16
        kw.update(n_heads=4, n_kv_heads=4, head_dim=32,
                  act_dtype="float32")
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, headdim=16,
                                        chunk=16)
    if cfg.d_ff_dense:
        kw["d_ff_dense"] = 512
    if cfg.n_img_tokens:
        kw["n_img_tokens"] = 8
    return dataclasses.replace(cfg, **kw)


# ----------------------------------------------------------------------
# Input specs (meta-device tensors; never allocate)
# ----------------------------------------------------------------------
def input_specs(cfg: ArchConfig, shape: ShapeSpec | str) -> dict:
    """Batch stand-ins for one step of the given shape, on the meta
    device with JAX's shapes and types.

    Modality frontends are stubs, as in JAX: ``[vlm]`` supplies
    precomputed patch embeddings, ``[audio]`` precomputed conv-frame
    embeddings, both as extra batch entries.
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    b = shape.batch

    def tok(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")
    if shape.kind == "train":
        out = {"tokens": tok((b, shape.seq), torch.int32),
               "labels": tok((b, shape.seq), torch.int32)}
    elif shape.kind == "prefill":
        out = {"tokens": tok((b, shape.seq), torch.int32)}
    else:  # decode: one new token against a seq-length KV cache
        out = {"tokens": tok((b, 1), torch.int32)}
    if cfg.n_img_tokens and shape.kind != "decode":
        out["patch_embeds"] = tok((b, cfg.n_img_tokens, cfg.d_model),
                                  torch.bfloat16)
    if cfg.encdec and shape.kind != "decode":
        out["frames"] = tok((b, cfg.enc_len, cfg.d_model), torch.bfloat16)
    return out
