"""Model loading: GGCC / GGJT file -> the port's parameter tree (port of
ggllm_tpu/io/loader.py load_params:412 / load_model:573, single device).

The tree mirrors the JAX kernel-path tree: {"tok_embeddings",
"output_norm", ["output_norm_b",] "lm_head", "layers": [per-layer dict]}.
Quantized 2-D weights stay packed as QuantTensors in ggml's planar layout
(which is also the Hopper kernel layout, so a file load is a copy) and
merge as the JAX loader merges them. Falcon (_merge_kernel_weights:117):

* shared-norm models (7B): [QKV; FFN-up] rows -> "wqkvu";
* wo / FFN-down along the contraction dim -> "w_od", fed [attn; gelu(ff)]
  (4544 = 142 * 32 and 18176 = 568 * 32: plain block concatenation);
* separate-norm models keep "wqkv" and "ffn_up"; mixed dense/quantized or
  mixed-format pairs stay separate ("wo", "ffn_down").

LLaMA (_load_llama_params:231): [wq; wk; wv] rows -> "wqkv" and [w1; w3]
rows -> "w13" (each pair shares an input), else the split keys; "wo" and
"w2" stay separate. A key whose ggml type differs between layers (the
reference's mixed K-type policy) is dequantized in every layer.

LoRA, the .kcache sidecar and meshes are not ported.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ggllm_tpu_torch.core.config import EngineConfig, FalconHParams
from ggllm_tpu_torch.core.device import resolve_device
from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.io.ggcc import ModelFile, read_model
from ggllm_tpu_torch.kernels.quant_matmul import K_QUANTS, KERNEL_FORMATS
from ggllm_tpu_torch.ops.linear import QuantTensor
from ggllm_tpu_torch.quant import planar


def _layer_names(hp: FalconHParams, i: int) -> dict[str, str]:
    """Tensor names per layer (libfalcon.cpp:1845-1861)."""
    p = f"transformer.h.{i}"
    names = {
        "qkv": f"{p}.self_attention.query_key_value.weight",
        "wo": f"{p}.self_attention.dense.weight",
        "ffn_up": f"{p}.mlp.dense_h_to_4h.weight",
        "ffn_down": f"{p}.mlp.dense_4h_to_h.weight",
    }
    if hp.n_falcon_type >= 40:
        names.update(input_ln_w=f"{p}.ln_mlp.weight", input_ln_b=f"{p}.ln_mlp.bias",
                     attn_ln_w=f"{p}.ln_attn.weight", attn_ln_b=f"{p}.ln_attn.bias")
    else:
        names.update(input_ln_w=f"{p}.input_layernorm.weight",
                     input_ln_b=f"{p}.input_layernorm.bias")
    return names


def _quant(gtype, shape, planes: dict, device) -> QuantTensor:
    """numpy planes (quant/planar.py dtypes) -> QuantTensor on device."""
    def tensor(a):  # torch needs contiguous, writable memory
        return torch.from_numpy(np.require(a, None, ["C", "W"])).to(device)

    return QuantTensor(gtype, shape, {k: tensor(v) for k, v in planes.items()})


def _load_matrix(mf: ModelFile, name: str, dtype, device, dense: bool = False):
    """2-D weight -> dense tensor (out, in) or QuantTensor (dense: always
    dequantized)."""
    t = mf.tensors[name]
    if dense or not GGMLType(t.gtype).name.startswith("Q"):
        return torch.from_numpy(mf.tensor_f32(name)).to(device=device, dtype=dtype)
    rows, cols = t.shape  # numpy convention: (out, in)
    return _quant(t.gtype, (rows, cols), planar.to_planes(t.gtype, mf.tensor_blob(name), rows, cols),
                  device)


def cat_quant(ws: list[QuantTensor], dim: int) -> QuantTensor:
    """Concatenate same-format QuantTensors along the output rows (dim 0) or
    the contraction dim (dim 1). Every plane is (rows, blocks, ...), so each
    concatenates along the same axis; along K this needs every width to be
    a whole number of blocks (super-blocks for K-quants), which a
    QuantTensor's shape always is."""
    shape = list(ws[0].shape)
    shape[dim] = sum(w.shape[dim] for w in ws)
    return QuantTensor(ws[0].gtype, tuple(shape),
                       {k: torch.cat([w.planes[k] for w in ws], dim) for k in ws[0].planes})


def _cat(ws: list, dim: int):
    """All-dense or same-format quantized weights concatenated along dim;
    None for a mixed set, which cannot merge."""
    if all(isinstance(w, QuantTensor) for w in ws):
        return cat_quant(ws, dim) if len({w.gtype for w in ws}) == 1 else None
    if any(isinstance(w, QuantTensor) for w in ws):
        return None
    return torch.cat(ws, dim)


def merge_weights(lw: dict, qkv, up, wo, down, parallel_norms: bool) -> dict:
    """The JAX kernel path's Falcon weight merge (see module docstring)."""
    wqkvu = None if parallel_norms else _cat([qkv, up], 0)
    if wqkvu is not None:
        lw["wqkvu"] = wqkvu
    else:
        lw["wqkv"], lw["ffn_up"] = qkv, up
    w_od = _cat([wo, down], 1)
    if w_od is not None:
        lw["w_od"] = w_od
    else:
        lw["wo"], lw["ffn_down"] = wo, down
    return lw


def _llama_names(i: int) -> dict[str, str]:
    """Tensor names per LLaMA layer (llama.cpp:1124-1151)."""
    p = f"layers.{i}"
    return {
        "attn_norm": f"{p}.attention_norm.weight",
        "wq": f"{p}.attention.wq.weight",
        "wk": f"{p}.attention.wk.weight",
        "wv": f"{p}.attention.wv.weight",
        "wo": f"{p}.attention.wo.weight",
        "ffn_norm": f"{p}.ffn_norm.weight",
        "w1": f"{p}.feed_forward.w1.weight",
        "w2": f"{p}.feed_forward.w2.weight",
        "w3": f"{p}.feed_forward.w3.weight",
    }


LLAMA_MATRICES = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def merge_llama_weights(lw: dict, mats: dict) -> dict:
    """The JAX kernel path's LLaMA weight merge (see module docstring)."""
    for merged, keys in (("wqkv", ("wq", "wk", "wv")), ("w13", ("w1", "w3"))):
        w = _cat([mats[k] for k in keys], 0)
        if w is not None:
            lw[merged] = w
        else:
            lw.update({k: mats[k] for k in keys})
    lw["wo"], lw["w2"] = mats["wo"], mats["w2"]
    return lw


def _load_llama_params(mf: ModelFile, dtype, device) -> dict:
    hp = mf.hparams

    def vec(name):
        return torch.from_numpy(mf.tensor_f32(name).astype(np.float32)).to(device)

    # a key with different ggml types across layers densifies in every layer
    dense_keys = {k for k in LLAMA_MATRICES
                  if len({mf.tensors[_llama_names(i)[k]].gtype for i in range(hp.n_layer)}) > 1}
    params: dict = {
        "tok_embeddings": torch.from_numpy(
            mf.tensor_f32("tok_embeddings.weight")).to(device=device, dtype=dtype),
        "output_norm": vec("norm.weight"),
        "lm_head": _load_matrix(mf, "output.weight", dtype, device),
        "layers": [],
    }
    for i in range(hp.n_layer):
        names = _llama_names(i)
        lw = {key: vec(names[key]) for key in ("attn_norm", "ffn_norm")}
        mats = {k: _load_matrix(mf, names[k], dtype, device, dense=k in dense_keys)
                for k in LLAMA_MATRICES}
        params["layers"].append(merge_llama_weights(lw, mats))
    return params


def load_params(mf: ModelFile, cfg: EngineConfig | None = None, device=None) -> dict:
    """Build the parameter tree from a parsed model file, on `device`
    (default "cuda"; raises if CUDA is missing unless device="cpu")."""
    cfg = cfg or EngineConfig()
    device = resolve_device(device)
    hp = mf.hparams
    dtype = getattr(torch, cfg.compute_dtype)
    if mf.arch == "llama":
        return _load_llama_params(mf, dtype, device)

    def vec(name):
        return torch.from_numpy(mf.tensor_f32(name).astype(np.float32)).to(device)

    params: dict = {
        # embeddings stay dense: get_rows needs random row access
        "tok_embeddings": torch.from_numpy(
            mf.tensor_f32("transformer.word_embeddings.weight")).to(device=device, dtype=dtype),
        "output_norm": vec("transformer.ln_f.weight"),
        "output_norm_b": vec("transformer.ln_f.bias"),
        "lm_head": _load_matrix(mf, "lm_head.weight", dtype, device),
        "layers": [],
    }
    for i in range(hp.n_layer):
        names = _layer_names(hp, i)
        lw = {key: vec(names[key]) for key in ("input_ln_w", "input_ln_b")}
        if hp.n_falcon_type >= 40:
            lw.update({key: vec(names[key]) for key in ("attn_ln_w", "attn_ln_b")})
        mats = {k: _load_matrix(mf, names[k], dtype, device)
                for k in ("qkv", "ffn_up", "wo", "ffn_down")}
        merge_weights(lw, mats["qkv"], mats["ffn_up"], mats["wo"], mats["ffn_down"],
                      hp.n_falcon_type >= 40)
        params["layers"].append(lw)
    return params


def load_model(path: str, cfg: EngineConfig | None = None, device=None):
    """Parse file + build params. Returns (ModelFile, params)."""
    mf = read_model(path)
    return mf, load_params(mf, cfg, device)


# ------------------------------------------------------ from the JAX package

# the JAX package's kernels/layout.py FORMATS code-plane recipes: the code is
# sum(plane << shift); a b-bit plane (n_k, ck*b/8, O) holds in byte row j of
# chunk c, bit-field i, column c*ck + i*(ck*b/8) + j; the 8-bit plane is the
# plain (n_k, ck, O) transpose
_KERNEL_CODE_PLANES = {
    GGMLType.Q4_0: (("q", 4, 0),),
    GGMLType.Q4_1: (("q", 4, 0),),
    GGMLType.Q5_0: (("q", 4, 0), ("h", 1, 4)),
    GGMLType.Q5_1: (("q", 4, 0), ("h", 1, 4)),
    GGMLType.Q8_0: (("q", 8, 0),),
    GGMLType.Q2_K: (("q", 2, 0),),
    GGMLType.Q3_K: (("q", 2, 0), ("h", 1, 2)),
    GGMLType.Q4_K: (("q", 4, 0),),
    GGMLType.Q5_K: (("q", 4, 0), ("h", 1, 4)),
    GGMLType.Q6_K: (("q", 4, 0), ("h", 2, 4)),
}


def _f16(a) -> np.ndarray:
    """fp16 scales from the JAX package: int16 bit patterns (viewed, never
    cast) or exactly fp16-representable f32 values."""
    a = np.asarray(a)
    return a.view(np.float16) if a.dtype == np.int16 else a.astype(np.float16)


def _planes_from_kernel(kq) -> dict[str, np.ndarray]:
    """A JAX KernelQuant (kernels/layout.py to_kernel) -> planar planes.

    Undoes the TPU layout: the code planes recombine into per-element codes,
    which quant/planar.py packs the ggml way; scales (n_k, ck//g, O) are
    transposed back. The contraction dim is zero-padded to n_k*ck there;
    the padding is cut. Q4_1/Q5_1 keep -m in their "ms" plane."""
    O, K = kq.shape
    gtype = GGMLType(int(kq.gtype))
    if gtype not in _KERNEL_CODE_PLANES:
        raise NotImplementedError(f"from_jax_params: {gtype.name}")

    def unchunk(a, n):  # (n_k, rows, O) -> (O, n), padding cut
        return np.asarray(a).reshape(-1, O).T[:, :n]

    codes = 0
    for name, bits, shift in _KERNEL_CODE_PLANES[gtype]:
        q = np.asarray(kq.planes[name])
        if bits == 8:
            part = q.view(np.int8).astype(np.int32)
        else:
            q = q.astype(np.uint8)
            part = np.concatenate([(q >> (i * bits)) & ((1 << bits) - 1)
                                   for i in range(8 // bits)], axis=1).astype(np.int32)
        codes = codes + (unchunk(part, K) << shift)
    planes = planar.planes_from_codes(gtype, codes)
    if gtype in K_QUANTS:
        nb = K // 256
        g = KERNEL_FORMATS[gtype][0]

        def sub(name, dtype):  # integer sub-scales, one per g elements
            return unchunk(kq.planes[name], K // g).astype(dtype).reshape(O, nb, 256 // g)

        planes["d"] = unchunk(_f16(kq.planes["db"]), nb)
        if "dminb" in kq.planes:
            planes["dmin"] = unchunk(_f16(kq.planes["dminb"]), nb)
        if gtype == GGMLType.Q2_K:
            planes["scb"] = sub("scb", np.uint8)
        else:
            planes["sc"] = sub("sc", np.int8)
        if "scm" in kq.planes:
            planes["scm"] = sub("scm", np.int8)
    else:
        planes["d"] = unchunk(_f16(kq.planes["ds"]), K // 32)
        if gtype in (GGMLType.Q4_1, GGMLType.Q5_1):
            planes["m"] = -unchunk(_f16(kq.planes["ms"]), K // 32)
    return planes


def _planes_from_planar(planes: dict) -> dict[str, np.ndarray]:
    """A JAX planar QuantTensor's planes -> the port's plane dtypes: fp16
    scales as float16, the legacy 5th-bit words as int32."""
    out = {}
    for name, a in planes.items():
        a = np.asarray(a)
        if name in ("d", "m", "dmin"):
            a = _f16(a)
        elif a.dtype == np.uint32:
            a = a.view(np.int32)
        out[name] = a
    return out


def _weight_from_jax(w, device, dtype):
    if hasattr(w, "ck"):  # KernelQuant
        return _quant(int(w.gtype), tuple(w.shape), _planes_from_kernel(w), device)
    if hasattr(w, "planes"):  # planar QuantTensor
        return _quant(int(w.gtype), tuple(w.shape), _planes_from_planar(w.planes), device)
    return torch.from_numpy(np.array(w, dtype=np.float32)).to(device=device, dtype=dtype)


def _split_rows_jax(w, i: int):
    """Layer i of a stacked planar QuantTensor / dense (L, ...) weight."""
    if hasattr(w, "planes"):
        return SimpleNamespace(gtype=w.gtype, shape=tuple(w.shape),
                               planes={k: np.asarray(v)[i] for k, v in w.planes.items()})
    return np.asarray(w)[i]


_NORM_KEYS = ("input_ln_w", "input_ln_b", "attn_ln_w", "attn_ln_b", "attn_norm", "ffn_norm")


def from_jax_params(tree: dict, dtype=torch.float32, device=None) -> dict:
    """The JAX loader's Falcon or LLaMA parameter tree, leaves converted to
    numpy, -> the port's tree. Takes the merged kernel-layout form
    (KernelQuant weights, a list of per-layer dicts) and the planar form
    (QuantTensor weights stacked on a leading layer axis, split wq/wk/wv;
    "attn_norm" marks a LLaMA tree, separate attention norms a 40B-style
    Falcon). The JAX classes are read by their attributes; nothing of the
    JAX package is imported."""
    device = resolve_device(device)

    def vec(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    params = {
        "tok_embeddings": torch.from_numpy(np.array(tree["tok_embeddings"], np.float32)).to(
            device=device, dtype=dtype),
        "output_norm": vec(tree["output_norm"]),
        "lm_head": _weight_from_jax(tree["lm_head"], device, dtype),
        "layers": [],
    }
    if "output_norm_b" in tree:
        params["output_norm_b"] = vec(tree["output_norm_b"])
    layers = tree["layers"]
    if isinstance(layers, (list, tuple)):  # kernel layout: merged, unstacked
        for lw in layers:
            params["layers"].append({
                k: vec(v) if k in _NORM_KEYS else _weight_from_jax(v, device, dtype)
                for k, v in lw.items()})
        return params
    llama = "attn_norm" in layers
    matrices = LLAMA_MATRICES if llama else ("wq", "wk", "wv", "wo", "ffn_up", "ffn_down")
    n_layer = np.asarray(layers["attn_norm" if llama else "input_ln_w"]).shape[0]
    for i in range(n_layer):  # planar: stacked, split q/k/v
        out = {k: vec(np.asarray(layers[k])[i]) for k in _NORM_KEYS if k in layers}
        w = {k: _weight_from_jax(_split_rows_jax(layers[k], i), device, dtype) for k in matrices}
        if llama:
            params["layers"].append(merge_llama_weights(out, w))
        else:
            params["layers"].append(merge_weights(
                out, _cat([w["wq"], w["wk"], w["wv"]], 0), w["ffn_up"], w["wo"],
                w["ffn_down"], "attn_ln_w" in layers))
    return params
