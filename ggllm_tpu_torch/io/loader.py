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

EngineConfig(weight_mode="dequant") then dequantizes every quantized weight
once, on its device, into the compute dtype (dequantize_params; the JAX
loader's dequant mode): the model multiplies dense weights, attention keeps
its kernels.

load_params(..., lora=, lora_base=) applies a 'ggla' LoRA adapter
(io/lora.py) at load, as the JAX loader does (load_params:440-470): each
patched weight becomes dense, its base dequantized in f32 on the load
device (or read from the unquantized lora_base file, the reference's
--lora-base) plus scaling * B @ A in f32, cast to the compute dtype. A key
patched in any layer is dense in every layer, so a merge whose pair mixes a
dense and a quantized weight falls back to the split keys (Falcon-7B with
only query_key_value patched: a dense "wqkv" beside a quantized "ffn_up").
An adapter tensor that is not one of the model's weight matrices is an
error; the JAX loader ignores it.

load_params(..., mesh=) under a tensor-parallel mesh (parallel/mesh.py,
cfg.kv_shard "heads") builds only this rank's blocks (the JAX loader's
_try_load_falcon_tp:299 / _try_load_llama_tp:347; parallel/tp.py), each read
from the memory-mapped file as its rows and block columns, with the
embeddings, norms and lm_head whole. Where the JAX loader sends a Falcon
model to its GSPMD fallback instead (a LoRA adapter, a layer of mixed quant
types or dense weights, weight_mode "dequant", a data axis, a plan the heads
or blocks do not divide) a rank builds the fallback tree (_load_split: the
JAX keys, each weight split as parallel/sharding.py says); LLaMA there
raises with the JAX loader's words. Under a sequence-parallel mesh
(kv_shard "sequence") every rank loads the whole model on its device.

The .kcache sidecar has no port (a load is a copy).
"""

from __future__ import annotations

import warnings
from types import SimpleNamespace

import numpy as np
import torch

from ggllm_tpu_torch.core.config import EngineConfig, FalconHParams
from ggllm_tpu_torch.core.device import resolve_device
from ggllm_tpu_torch.core.dtypes import GGMLType
from ggllm_tpu_torch.io import lora as lora_mod
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


def _quantized(mf: ModelFile, name: str) -> bool:
    return GGMLType(mf.tensors[name].gtype).name.startswith("Q")


def _load_matrix(mf: ModelFile, name: str, dtype, device, dense: bool = False, patch=None):
    """2-D weight -> dense tensor (out, in) or QuantTensor (dense: always
    dequantized). patch: (LoraFile, base ModelFile) or None; a weight the
    adapter patches is its f32 base on `device` plus the adapter's delta
    there (io/lora.py apply_to_tensor), in dtype."""
    if patch is not None and name in patch[0].tensors:
        lf, base = patch
        w = (_load_matrix(base, name, torch.float32, device).dequantize(torch.float32)
             if _quantized(base, name) else torch.from_numpy(base.tensor_f32(name)).to(device))
        return lora_mod.apply_to_tensor(w, lf, name).to(dtype)
    t = mf.tensors[name]
    if dense or not _quantized(mf, name):
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


def _patched_keys(patch, names: list[dict[str, str]]) -> set[str]:
    """The per-layer keys whose weight the adapter patches in any layer."""
    if patch is None:
        return set()
    return {k for lw in names for k, name in lw.items() if name in patch[0].tensors}


def _load_llama_params(mf: ModelFile, dtype, device, patch=None) -> dict:
    hp = mf.hparams

    def vec(name):
        return torch.from_numpy(mf.tensor_f32(name).astype(np.float32)).to(device)

    # a key with different ggml types across layers, or one the adapter
    # patches in any layer, densifies in every layer
    dense_keys = {k for k in LLAMA_MATRICES
                  if len({mf.tensors[_llama_names(i)[k]].gtype for i in range(hp.n_layer)}) > 1}
    dense_keys |= _patched_keys(patch, [_llama_names(i) for i in range(hp.n_layer)])
    params: dict = {
        "tok_embeddings": torch.from_numpy(
            mf.tensor_f32("tok_embeddings.weight")).to(device=device, dtype=dtype),
        "output_norm": vec("norm.weight"),
        "lm_head": _load_matrix(mf, "output.weight", dtype, device, patch=patch),
        "layers": [],
    }
    for i in range(hp.n_layer):
        names = _llama_names(i)
        lw = {key: vec(names[key]) for key in ("attn_norm", "ffn_norm")}
        mats = {k: _load_matrix(mf, names[k], dtype, device, dense=k in dense_keys, patch=patch)
                for k in LLAMA_MATRICES}
        params["layers"].append(merge_llama_weights(lw, mats))
    return params


def dequantize_params(params: dict, dtype) -> dict:
    """The tree with every QuantTensor dequantized (in f32, then to dtype)
    on its own device; dense leaves and the layer list's structure kept."""
    def leaf(w):
        return w.dequantize(torch.float32).to(dtype) if isinstance(w, QuantTensor) else w

    return {k: [{n: leaf(w) for n, w in lw.items()} for lw in v] if k == "layers" else leaf(v)
            for k, v in params.items()}


FALCON_MATRICES = ("qkv", "ffn_up", "wo", "ffn_down")


def _matrix_names(mf: ModelFile) -> set[str]:
    """The tensor names of every weight matrix the model multiplies by (the
    ones an adapter may patch)."""
    hp = mf.hparams
    if mf.arch == "llama":
        return {"output.weight"} | {_llama_names(i)[k] for i in range(hp.n_layer)
                                    for k in LLAMA_MATRICES}
    return {"lm_head.weight"} | {_layer_names(hp, i)[k] for i in range(hp.n_layer)
                                 for k in FALCON_MATRICES}


def _lora_patch(mf: ModelFile, lora, lora_base):
    """(LoraFile, the ModelFile its bases are read from), after the JAX
    loader's checks (load_params:440-470): an error where lora_base lacks a
    patched tensor, a UserWarning for a quantized patch without one; and an
    error for an adapter tensor that is not one of the model's matrices."""
    lf = lora_mod.read_lora(lora) if isinstance(lora, str) else lora
    unknown = sorted(set(lf.tensors) - _matrix_names(mf))
    if unknown:
        raise ValueError(
            f"LoRA adapter tensor(s) {unknown[:3]}{'...' if len(unknown) > 3 else ''} are not"
            f" weight matrices of this {mf.arch} model (absent from {mf.path}, or not a 2-D"
            " weight it multiplies by)")
    if lora_base is None:
        if any(_quantized(mf, name) for name in lf.tensors):
            warnings.warn(
                "applying a LoRA adapter to quantized tensors without "
                "--lora-base: deltas are added to dequantized values, which "
                "may degrade quality (libfalcon.cpp:4110-4116)")
        return lf, mf
    base = read_model(lora_base) if isinstance(lora_base, str) else lora_base
    # the reference errors when a patched tensor is absent from the base
    # model (libfalcon.cpp:4095-4098) rather than silently falling back to
    # the quantized model's dequantized values
    missing = [n for n in lf.tensors if n in mf.tensors and n not in base.tensors]
    if missing:
        raise ValueError(
            f"--lora-base model is missing LoRA-patched tensor(s) "
            f"{missing[:3]}{'...' if len(missing) > 3 else ''}")
    return lf, base


def load_params(mf: ModelFile, cfg: EngineConfig | None = None, device=None, lora=None,
                lora_base=None, mesh=None) -> dict:
    """Build the parameter tree from a parsed model file, on `device`
    (default "cuda"; raises if CUDA is missing unless device="cpu");
    weight_mode "dequant" dequantizes it there (dequantize_params).
    lora: a LoraFile or the path of a 'ggla' adapter, applied there to the
    weights it names; lora_base: a ModelFile or the path of an unquantized
    model whose tensors are the bases of the patched weights. mesh: a
    parallel/mesh.py Mesh; the tree goes on its device, and under
    tensor parallelism holds this rank's blocks (see the module docstring)."""
    cfg = cfg or EngineConfig()
    if cfg.weight_mode not in ("fused", "dequant"):
        raise ValueError(f"weight_mode {cfg.weight_mode!r}: fused or dequant")
    if mesh is not None:
        device = mesh.device
        if cfg.kv_shard != "sequence":
            return _load_tp(mf, cfg, mesh, lora, lora_base)
    device = resolve_device(device)
    dtype = getattr(torch, cfg.compute_dtype)
    patch = None if lora is None else _lora_patch(mf, lora, lora_base)
    load = _load_llama_params if mf.arch == "llama" else _load_falcon_params
    params = load(mf, dtype, device, patch)
    return dequantize_params(params, dtype) if cfg.weight_mode == "dequant" else params


def _load_falcon_params(mf: ModelFile, dtype, device, patch=None) -> dict:
    hp = mf.hparams

    def vec(name):
        return torch.from_numpy(mf.tensor_f32(name).astype(np.float32)).to(device)

    # a key the adapter patches in any layer densifies in every layer, as
    # the JAX loader's stacked tree has it
    dense_keys = _patched_keys(patch, [{k: _layer_names(hp, i)[k] for k in FALCON_MATRICES}
                                       for i in range(hp.n_layer)])
    params: dict = {
        # embeddings stay dense: get_rows needs random row access
        "tok_embeddings": torch.from_numpy(
            mf.tensor_f32("transformer.word_embeddings.weight")).to(device=device, dtype=dtype),
        "output_norm": vec("transformer.ln_f.weight"),
        "output_norm_b": vec("transformer.ln_f.bias"),
        "lm_head": _load_matrix(mf, "lm_head.weight", dtype, device, patch=patch),
        "layers": [],
    }
    for i in range(hp.n_layer):
        names = _layer_names(hp, i)
        lw = {key: vec(names[key]) for key in ("input_ln_w", "input_ln_b")}
        if hp.n_falcon_type >= 40:
            lw.update({key: vec(names[key]) for key in ("attn_ln_w", "attn_ln_b")})
        mats = {k: _load_matrix(mf, names[k], dtype, device, dense=k in dense_keys, patch=patch)
                for k in FALCON_MATRICES}
        merge_weights(lw, mats["qkv"], mats["ffn_up"], mats["wo"], mats["ffn_down"],
                      hp.n_falcon_type >= 40)
        params["layers"].append(lw)
    return params


def load_model(path: str, cfg: EngineConfig | None = None, device=None, lora=None,
               lora_base=None, mesh=None):
    """Parse file + build params (load_params). Returns (ModelFile, params)."""
    mf = read_model(path)
    return mf, load_params(mf, cfg, device, lora=lora, lora_base=lora_base, mesh=mesh)


def _load_tp(mf: ModelFile, cfg: EngineConfig, mesh, lora, lora_base) -> dict:
    """This rank's tensor-parallel tree (parallel/tp.py) where the JAX loader
    takes its TP plan (_try_load_falcon_tp:299), else the fallback tree
    (_load_split); LLaMA has no fallback and raises with the JAX loader's
    words (load_params:474-479)."""
    from ggllm_tpu_torch.parallel import tp

    hp, device = mf.hparams, mesh.device
    why = ("a LoRA adapter densifies the weights it patches" if lora is not None
           else f"a data axis of {mesh.data}" if mesh.data != 1
           else f"weight_mode {cfg.weight_mode!r}" if cfg.weight_mode != "fused" else None)
    try:
        if why is not None:
            raise NotImplementedError(why)
        try:
            plan = tp.TpPlan(hp, mesh.model)
        except ValueError as e:
            raise NotImplementedError(str(e)) from None
        dtype = getattr(torch, cfg.compute_dtype)

        def vec(name):
            return torch.from_numpy(mf.tensor_f32(name).astype(np.float32)).to(device)

        def blocks(lw, built):
            for key, (gt, shape, planes) in built.items():
                lw[key] = _quant(gt, shape, planes, device)
            return lw

        llama = mf.arch == "llama"
        emb = "tok_embeddings.weight" if llama else "transformer.word_embeddings.weight"
        params = {"tok_embeddings": torch.from_numpy(mf.tensor_f32(emb)).to(device=device,
                                                                           dtype=dtype)}
        if llama:
            params.update(output_norm=vec("norm.weight"),
                          lm_head=_load_matrix(mf, "output.weight", dtype, device), layers=[])
            for i in range(hp.n_layer):
                names = _llama_names(i)
                lw = {k: vec(names[k]) for k in ("attn_norm", "ffn_norm")}
                params["layers"].append(blocks(lw, tp.llama_layer(mf, names, plan, mesh.rank)))
        else:
            params.update(output_norm=vec("transformer.ln_f.weight"),
                          output_norm_b=vec("transformer.ln_f.bias"),
                          lm_head=_load_matrix(mf, "lm_head.weight", dtype, device), layers=[])
            for i in range(hp.n_layer):
                names = _layer_names(hp, i)
                lw = {k: vec(names[k]) for k in _falcon_norms(hp)}
                params["layers"].append(blocks(lw, tp.falcon_layer(
                    mf, names, plan, mesh.rank, merge_up=hp.n_falcon_type < 40)))
        return params
    except NotImplementedError as e:
        if mf.arch == "llama":  # the JAX loader's words (load_params:474-479)
            raise NotImplementedError(
                "multi-chip LLaMA needs the TP plan (uniform quant type, mp | n_head, no LoRA,"
                f" no data axis): {e}") from None
    patch = None if lora is None else _lora_patch(mf, lora, lora_base)
    return _load_split(mf, cfg, mesh, patch)


def _falcon_norms(hp) -> tuple:
    return (("input_ln_w", "input_ln_b", "attn_ln_w", "attn_ln_b") if hp.n_falcon_type >= 40
            else ("input_ln_w", "input_ln_b"))


# the fallback tree's keys: (file matrix, rows of it: q, k, v or all)
SPLIT_KEYS = {"wq": ("qkv", "q"), "wk": ("qkv", "k"), "wv": ("qkv", "v"), "wo": ("wo", None),
              "ffn_up": ("ffn_up", None), "ffn_down": ("ffn_down", None)}


def _split_descs(mf: ModelFile, cfg: EngineConfig, patch) -> dict:
    """The fallback tree's weights as descriptions: {"lm_head", "layers": [
    {key: (tensor name, first row, shape, gtype or None where dense, whether
    the adapter patches it)}]}, dense where the JAX GSPMD tree is (an
    adapter's keys in every layer, weight_mode "dequant", a file tensor that
    is not quantized)."""
    hp = mf.hparams
    D = hp.head_dim
    dense_keys = _patched_keys(patch, [{k: _layer_names(hp, i)[k] for k in FALCON_MATRICES}
                                       for i in range(hp.n_layer)])
    rows = {"q": (0, hp.n_head * D), "k": (hp.n_head * D, hp.n_head_kv * D),
            "v": ((hp.n_head + hp.n_head_kv) * D, hp.n_head_kv * D)}

    def desc(name, dense, part=None):
        t = mf.tensors[name]
        r0, n = rows[part] if part else (0, t.shape[0])
        quant = _quantized(mf, name) and not dense and cfg.weight_mode != "dequant"
        return SimpleNamespace(name=name, row0=r0, shape=(n, t.shape[1]),
                               gtype=GGMLType(t.gtype) if quant else None,
                               patched=patch is not None and name in patch[0].tensors)

    lm = desc("lm_head.weight", patch is not None and "lm_head.weight" in patch[0].tensors)
    layers = []
    for i in range(hp.n_layer):
        names = _layer_names(hp, i)
        layers.append({key: desc(names[m], m in dense_keys, part)
                       for key, (m, part) in SPLIT_KEYS.items()})
    emb = mf.tensors["transformer.word_embeddings.weight"]
    return {"tok_embeddings": SimpleNamespace(shape=emb.shape), "lm_head": lm, "layers": layers}


def split_specs(mf: ModelFile, cfg: EngineConfig, mp: int, lora=None, lora_base=None) -> dict:
    """The split of every weight of a Falcon file's fallback tree at mp model
    ranks (parallel/sharding.py param_specs)."""
    from ggllm_tpu_torch.parallel import sharding

    patch = None if lora is None else _lora_patch(mf, lora, lora_base)
    return sharding.param_specs(_split_descs(mf, cfg, patch), mf.hparams, mp)


def _load_split(mf: ModelFile, cfg: EngineConfig, mesh, patch) -> dict:
    """This rank's fallback tree (the JAX loader's GSPMD tree, load_params:
    483-530, as one rank's splits): the JAX keys wq / wk / wv / wo / ffn_up /
    ffn_down a layer (and the norms), each weight this rank's rows or block
    columns as parallel/sharding.py param_specs splits it (a quantized one
    read as those planes alone from the memory-mapped file), the embedding
    its columns, and the specs under "split" for the engine. Dense weights
    as the single-process loader makes them: an adapter's patched keys its
    f32 base plus the delta, weight_mode "dequant" the planes dequantized
    in f32 on the device (a rank's planes alone), both cast to the compute
    dtype."""
    from ggllm_tpu_torch.parallel import sharding, tp

    hp, device, mp, r = mf.hparams, mesh.device, mesh.model, mesh.rank
    dtype = getattr(torch, cfg.compute_dtype)
    descs = _split_descs(mf, cfg, patch)
    specs = sharding.param_specs(descs, hp, mp)

    def vec(name):
        return torch.from_numpy(mf.tensor_f32(name).astype(np.float32)).to(device)

    patched = {}  # the last patched matrix (wq, wk and wv share query_key_value)

    def weight(d, spec):
        O, K = d.shape
        rows = sharding.span(O, mp, r) if spec == sharding.OUT else (0, O)
        rows = (d.row0 + rows[0], d.row0 + rows[1])
        cols = sharding.span(K, mp, r) if spec == sharding.IN else (0, K)
        if d.patched:
            if d.name not in patched:
                patched.clear()
                patched[d.name] = _load_matrix(mf, d.name, torch.float32, device, patch=patch)
            full = patched[d.name]
        elif _quantized(mf, d.name):  # this rank's planes alone, dequantized where dense
            sh = tp.Shard(mf, d.name)
            planes = sh.planes(rows, (cols[0] // sh.bs, cols[1] // sh.bs))
            w = _quant(sh.gtype, (rows[1] - rows[0], cols[1] - cols[0]), planes, device)
            return w if d.gtype is not None else w.dequantize(torch.float32).to(dtype)
        else:
            full = torch.from_numpy(mf.tensor_f32(d.name))
        return full[rows[0]:rows[1], cols[0]:cols[1]].to(device=device, dtype=dtype)

    emb = torch.from_numpy(mf.tensor_f32("transformer.word_embeddings.weight"))
    if specs["tok_embeddings"] == sharding.IN:
        emb = emb[:, slice(*sharding.span(emb.shape[1], mp, r))]
    params = {"tok_embeddings": emb.to(device=device, dtype=dtype),
              "output_norm": vec("transformer.ln_f.weight"),
              "output_norm_b": vec("transformer.ln_f.bias"),
              "lm_head": weight(descs["lm_head"], specs["lm_head"]),
              "layers": [], "split": specs}
    for i in range(hp.n_layer):
        names = _layer_names(hp, i)
        lw = {k: vec(names[k]) for k in _falcon_norms(hp)}
        for key, d in descs["layers"][i].items():
            lw[key] = weight(d, specs["layers"][i][key])
        params["layers"].append(lw)
    return params


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
