"""Model hyperparameters and engine configuration (the subset of
ggllm_tpu/core/config.py that the PyTorch port reads)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class FalconHParams:
    """Falcon model hyperparameters (falcon_hparams, libfalcon.cpp:146-160)."""

    n_vocab: int = 65024
    n_embd: int = 4544
    n_head: int = 71
    n_head_kv: int = 1  # 1 = 7B multi-query; 8 = 40B grouped-query
    n_layer: int = 32
    n_falcon_type: int = 7  # 7, 40 or 180
    ftype: int = 1
    n_bpe_merges: int = 64784

    arch = "falcon"

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def n_ff(self) -> int:
        return 4 * self.n_embd

    @classmethod
    def falcon7b(cls, **kw) -> "FalconHParams":
        return cls(n_embd=4544, n_head=71, n_head_kv=1, n_layer=32, n_falcon_type=7, **kw)

    @classmethod
    def falcon40b(cls, **kw) -> "FalconHParams":
        return cls(n_embd=8192, n_head=128, n_head_kv=8, n_layer=60, n_falcon_type=40, **kw)

    @classmethod
    def falcon180b(cls, **kw) -> "FalconHParams":
        return cls(n_embd=14848, n_head=232, n_head_kv=8, n_layer=80, n_falcon_type=180, **kw)

    @classmethod
    def tiny(cls, **kw) -> "FalconHParams":
        """Small config for tests: same structure, toy sizes."""
        kw.setdefault("n_vocab", 512)
        kw.setdefault("n_bpe_merges", 0)
        return cls(n_embd=128, n_head=4, n_head_kv=1, n_layer=2, n_falcon_type=7, **kw)

    @classmethod
    def tiny_gqa(cls, **kw) -> "FalconHParams":
        """Tiny 40B-style config (grouped-query attention, two layernorms)."""
        kw.setdefault("n_vocab", 512)
        kw.setdefault("n_bpe_merges", 0)
        return cls(n_embd=128, n_head=8, n_head_kv=2, n_layer=2, n_falcon_type=40, **kw)


@dataclass
class LlamaHParams:
    """LLaMA hyperparameters (llama_hparams, llama.cpp:124-133)."""

    n_vocab: int = 32000
    n_embd: int = 4096
    n_mult: int = 256
    n_head: int = 32
    n_layer: int = 32
    n_rot: int = 64
    ftype: int = 1

    arch = "llama"

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def n_head_kv(self) -> int:
        return self.n_head  # LLaMA-1: no grouped-query attention

    @property
    def n_ff(self) -> int:
        # llama.cpp:1074
        return ((2 * (4 * self.n_embd) // 3 + self.n_mult - 1)
                // self.n_mult) * self.n_mult

    @classmethod
    def llama7b(cls, **kw) -> "LlamaHParams":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "LlamaHParams":
        kw.setdefault("n_vocab", 512)
        return cls(n_embd=128, n_mult=32, n_head=4, n_layer=2, n_rot=32, **kw)


def named_hparams(name: str) -> FalconHParams | LlamaHParams:
    """"falcon7b", "falcon40b", "falcon180b" or "llama7b" -> that model's
    hyperparameters."""
    return getattr(LlamaHParams if name.startswith("llama") else FalconHParams, name)()


@dataclass
class RopeConfig:
    """NTK-aware dynamic RoPE scaling knobs (ggml.h:1564-1567, ggml.c:12875-12898)."""

    freq_base: float = 10000.0
    # None = auto: enabled for falcon (falcon_eval turns dynamic mode on by
    # default, libfalcon.cpp:2229-2234), disabled for llama (the reference
    # llama.cpp applies no NTK scaling to classic RoPE)
    dynamic_ntk: bool | None = None
    # dynamic mode: the linear scale inside the alpha formula (falcon_eval
    # passes 2.0, libfalcon.cpp:2234); static mode: the NTK alpha itself
    ntk_alpha: float = 2.0
    ang_scale: float = 1.0  # linear angle scaling
    trained_ctx: int = 2048  # context length the base model was trained at


@dataclass
class EngineConfig:
    """Runtime configuration (the gpt_params subset that shapes compute)."""

    n_ctx: int = 2048
    n_batch: int = 512  # prefill chunk
    decode_chunk: int = 16  # tokens per decode_chunk call in generate()
    kv_dtype: str = "bfloat16"  # "float32" for exactness; "int8": codes + f32 scales
    compute_dtype: str = "bfloat16"
    rope: RopeConfig = field(default_factory=RopeConfig)
    # "fused": quantized weights stay packed and run through the kernels;
    # "dequant": the loader dequantizes each quantized 2-D weight once into
    # the compute dtype, and they multiply as dense tensors
    weight_mode: str = "fused"
    # quantized matmuls through the hand-written kernel (True) or the plain
    # dequantize-then-matmul version (False); None = True
    kernel_layout: bool | None = None
    # attention through the flash kernels (True) or the plain einsum
    # version (False); None = True
    flash_attention: bool | None = None
    # under a mesh (parallel/mesh.py): "heads" = tensor parallelism (the KV
    # cache split by K/V head, whole for MQA); "sequence" = the KV cache
    # split along time, weights whole on every rank (parallel/sp.py)
    kv_shard: str = "heads"
