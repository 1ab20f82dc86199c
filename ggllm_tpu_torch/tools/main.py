"""falcon_main equivalent on the port (ggllm_tpu/tools/main.py, minus the
modes that wait for their modules): load a Falcon GGCC file or a LLaMA GGJT
file, tokenize the prompt with the file's tokenizer (BOS first), and
generate through engine/generator.py, with the full sampling cascade,
antiprompts (-r), stopwords (-S, with streaming holdback so a stop string
split across tokens never leaks), finetune templates, interactive mode,
context swap past n_ctx (--keep, falcon_main.cpp:694-760) and logit bias;
--perplexity (over -f FILE, engine/perplexity.py) and --embedding (the
prompt's final hidden state) run those modes instead of generating.
--grammar GBNF / --grammar-file FNAME constrain generation to a grammar
(ops/grammar.py; masked decode chunks on the device, engine/generator.py).
--prompt-cache FNAME reuses the longest prompt prefix a session file holds
and saves the evaluated prompt (engine/session.py; --prompt-cache-all also
the generated ids, --prompt-cache-ro never writes). --draft-model FNAME or
--self-draft N decode speculatively (engine/speculative.py: --draft-k drafts
a round, verified in one forward of the model), plain generation only.
--mtest runs a full-batch prefill and one decode step and reports the
timings and the card's memory; --weight-mode dequant dequantizes every
quantized weight once at load (dense matmuls, the library's path);
--lora FNAME applies a 'ggla' LoRA adapter at load (io/lora.py: each
patched weight becomes dense, its base dequantized on the card, or read
from the unquantized --lora-base FNAME model); a --draft-model loads
without it, a --self-draft shares the patched weights.
--profile DIR writes a torch.profiler trace of generation, and -dt LEVEL
prints its op table (utils/traceview.py). The reference's thread, VRAM and
mmap flags are accepted and ignored, so reference command lines run
unchanged. --export PATH writes the forward of one n_batch chunk as a
torch.export program's text (FalconEngine.export: its graph signature and
every node, the hand kernels as torch.ops.ggllm.*) and exits.

-ts N (--tensor-split) shards the model over N ranks (parallel/mesh.py),
one a device: this process is rank 0, owns stdin and stdout, and starts the
other N - 1 itself (--device cpu: N CPU ranks over gloo; on cards, NCCL when
each rank has its own); --kv-shard heads is tensor parallelism,
--kv-shard sequence the sequence-parallel Falcon (the cache split along
time); -ts auto picks the smallest split whose per-card footprint fits
(parallel/plan.py). --multihost joins the world torchrun's environment
describes instead (one process a card on each host). Speculative decoding
and grammars take one device.

    python -m ggllm_tpu_torch.tools.main -m model.ggcc -p "Hello" -n 64

Sampler settings that the device cascade covers decode in pipelined chunks
of --decode-chunk tokens, each one replay of a captured CUDA graph on the
card; the rest (--top-k 0, --tfs, --typical, --mirostat), and every setting
under --no-fused-decode, go one token at a time through the host cascade
(ops/sampling.py). Flags, names and defaults are the JAX CLI's. Runs on the
CUDA card unless --device cpu is given. --kv-dtype picks the KV cache's
storage: bfloat16 (default), float32 (also --memory-f32) or int8 (codes
with one f32 scale per cached position and head).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

from ggllm_tpu_torch import tokenizer as tok_mod
from ggllm_tpu_torch.core.config import EngineConfig
from ggllm_tpu_torch.engine import session as session_mod
from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.engine.generator import Generator
from ggllm_tpu_torch.io.loader import load_model
from ggllm_tpu_torch.ops.sampling import SamplerParams
from ggllm_tpu_torch.utils.finetune import build_prompt, detect_finetune, finetune_stopwords
from ggllm_tpu_torch.utils.stream import StopStream


def parse_logit_bias(specs: list[str]) -> dict[int, float]:
    """--logit-bias TOKEN_ID(+|-)BIAS, e.g. '15043+1.5' or '2-inf' to ban
    (falcon_common.cpp gpt_params_parse logit-bias handling)."""
    out: dict[int, float] = {}
    for spec in specs:
        for sep in ("+", "-"):
            i = spec.find(sep, 1)
            if i > 0:
                tid = int(spec[:i])
                val = spec[i + 1:]
                bias = float("-inf") if val.lower() == "inf" and sep == "-" else \
                    float(val) * (1 if sep == "+" else -1)
                out[tid] = bias
                break
        else:
            raise ValueError(f"bad --logit-bias spec: {spec!r}")
    return out


ANSI_RESET = "\x1b[0m"
ANSI_PROMPT = "\x1b[33m"        # yellow: prompt echo
ANSI_USER = "\x1b[1;32m"        # bold green: user input

RANDOM_PROMPTS = ["So", "Once upon a time", "When", "The", "After",
                  "If", "import", "He", "She", "They"]


def read_user_input(multiline: bool) -> str | None:
    """Console line protocol (examples/common.cpp console_readline):

    default mode — Return submits; a trailing '\\' continues on another
    line; a trailing '/' submits without the final newline.
    multiline mode — Return inserts a newline; a trailing '\\' submits;
    '/' submits without the newline. Returns None at EOF with no input.
    """
    lines: list[str] = []
    while True:
        try:
            line = input()
        except EOFError:
            return None if not lines else "\n".join(lines) + "\n"
        if line.endswith("\\"):
            lines.append(line[:-1])
            if multiline:
                return "\n".join(lines) + "\n"
            continue
        if line.endswith("/"):
            lines.append(line[:-1])
            return "\n".join(lines)
        lines.append(line)
        if not multiline:
            return "\n".join(lines) + "\n"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default="")
    ap.add_argument("-f", "--file", help="read prompt from file")
    ap.add_argument("--random-prompt", action="store_true",
                    help="start with a short randomized prompt")
    ap.add_argument("-n", "--n-predict", type=int, default=128)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("-b", "--batch-size", type=int, default=512)
    ap.add_argument("-s", "--seed", type=int, default=-1)
    ap.add_argument("--keep", type=int, default=0, dest="n_keep",
                    help="tokens kept from the prompt head on context swap; -1 = whole prompt")
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--tfs", type=float, default=1.0)
    ap.add_argument("--typical", type=float, default=1.0)
    ap.add_argument("--temp", type=float, default=0.8)
    ap.add_argument("--repeat-penalty", type=float, default=1.1)
    ap.add_argument("--repeat-last-n", type=int, default=64)
    ap.add_argument("--frequency-penalty", type=float, default=0.0)
    ap.add_argument("--presence-penalty", type=float, default=0.0)
    ap.add_argument("--mirostat", type=int, default=0, choices=[0, 1, 2])
    ap.add_argument("--mirostat-tau", "--mirostat-ent", type=float, default=5.0,
                    dest="mirostat_tau", help="mirostat target entropy tau")
    ap.add_argument("--mirostat-eta", "--mirostat-lr", type=float, default=0.1,
                    dest="mirostat_eta", help="mirostat learning rate eta")
    ap.add_argument("--no-penalize-nl", action="store_true")
    ap.add_argument("-l", "--logit-bias", action="append", default=[],
                    metavar="TOKEN_ID(+|-)BIAS",
                    help="add BIAS to a token's logit ('-inf' bans it); repeatable")
    ap.add_argument("--ignore-eos", action="store_true",
                    help="never emit end-of-text (bans the EOS logit, the reference's"
                         " --ignore-eos logit_bias[eos]=-inf)")
    ap.add_argument("-r", "--reverse-prompt", action="append", default=[],
                    help="antiprompt: stop generation when seen")
    ap.add_argument("-S", "--stopwords", default=None,
                    help="pipe-separated stopwords ('' disables finetune defaults)")
    ap.add_argument("-i", "--interactive", action="store_true")
    ap.add_argument("--interactive-first", action="store_true",
                    help="interactive mode, waiting for input before generating anything")
    ap.add_argument("-ins", "--instruct", action="store_true")
    ap.add_argument("--in-prefix", default="",
                    help="string prepended to every interactive user input")
    ap.add_argument("--in-suffix", default="",
                    help="string appended to every interactive user input")
    ap.add_argument("--multiline-input", action="store_true",
                    help="interactive input spans lines until a trailing '\\'")
    ap.add_argument("--color", action="store_true",
                    help="colorize output: prompt yellow, input green")
    ap.add_argument("--sys-prompt", "--system", default=None, dest="sys_prompt",
                    help="system prompt (finetune templated)")
    ap.add_argument("--system-file", default=None, help="read the system prompt from a file")
    ap.add_argument("--system-raw", action="store_true",
                    help="prepend the system prompt verbatim, no template")
    ap.add_argument("-enc", "--enclose-prompt", action="store_true",
                    help="wrap -p in the detected finetune template")
    ap.add_argument("--finetune", default="auto",
                    choices=["auto", "none", "alpaca", "openassistant", "wizard", "falcon_ins"],
                    help="finetune template override")
    ap.add_argument("--prompt-cache", default=None, help="session file path")
    ap.add_argument("--prompt-cache-all", action="store_true",
                    help="also save generated output to the session file")
    ap.add_argument("--prompt-cache-ro", action="store_true",
                    help="use the session file read-only, never update it")
    ap.add_argument("--verbose-prompt", action="store_true",
                    help="print the tokenization of every ingested prompt")
    ap.add_argument("--perplexity", action="store_true",
                    help="compute perplexity over -f FILE and exit (the "
                         "falcon_perplexity protocol)")
    ap.add_argument("--embedding", action="store_true",
                    help="print the prompt's final hidden state and exit "
                         "(the examples/embedding mode)")
    ap.add_argument("--mtest", action="store_true",
                    help="compute maximum-memory usage (full-batch prefill + one decode step),"
                         " report, and exit")
    ap.add_argument("--export", default=None, metavar="PATH",
                    help="write the forward graph of one -b chunk (torch.export) to PATH and"
                         " exit")
    ap.add_argument("--lora", default=None, help="apply a 'ggla' LoRA adapter")
    ap.add_argument("--lora-base", default=None,
                    help="unquantized model whose tensors serve as the base for LoRA-patched"
                         " weights")
    # accepted-and-ignored reference flags, so reference command lines run
    # unchanged (the thread and VRAM knobs mean nothing here: the weights
    # and the cache live on the card, PyTorch owns its memory)
    for flag, extra in (("--threads", {"type": int}), ("-t", {"type": int}),
                        ("--n-gpu-layers", {"type": int}),
                        ("-ngl", {"type": int}), ("--gpu-layers", {"type": int}),
                        ("--main-gpu", {"type": int}),
                        ("--gpu-reserve-mb-main", {"type": int}),
                        ("--gpu-reserve-mb-other", {"type": int}),
                        ("--override-max-gpu", {"type": int}),
                        ("--mlock", {"action": "store_true"}),
                        ("--low-vram", {"action": "store_true"}),
                        ("--no-mmap", {"action": "store_true"})):
        ap.add_argument(flag, dest="_compat", help=argparse.SUPPRESS, **extra)
    ap.add_argument("--alias", default=None,
                    help="model display name in reports (falcon_common model_alias)")
    ap.add_argument("--display-timings", dest="verbose_timings", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--memory-f32", action="store_true",
                    help="store the KV cache in f32 (sets --kv-dtype float32)")
    ap.add_argument("--kv-dtype", default="bfloat16", choices=("bfloat16", "float32", "int8"))
    ap.add_argument("--compute-dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--weight-mode", default="fused", choices=["fused", "dequant"],
                    help="fused: quantized weights through the kernels; dequant: every quantized"
                         " weight dequantized once at load to the compute dtype")
    ap.add_argument("--no-fused-decode", action="store_true",
                    help="force the per-token host sampling path")
    ap.add_argument("--decode-chunk", type=int, default=16,
                    help="tokens per CUDA graph replay in the fused decode loop (larger ="
                         " faster, chunkier streaming)")
    ap.add_argument("--draft-model", default=None, metavar="FNAME",
                    help="speculative decoding: a smaller same-vocab model drafts tokens the main"
                         " model verifies in batches; output is distributed exactly as without a"
                         " draft (engine/speculative.py; not in the reference)")
    ap.add_argument("--draft-k", type=int, default=6,
                    help="draft tokens per speculative round")
    ap.add_argument("--grammar", default="", metavar="GBNF",
                    help="constrain generation to a GBNF grammar (llama.cpp grammar dialect;"
                         " masked device steps, multi-step chunks over self-looping states)")
    ap.add_argument("--grammar-file", default="", metavar="FNAME",
                    help="read the GBNF grammar from a file")
    ap.add_argument("--self-draft", type=int, default=0, metavar="N",
                    help="speculative decoding with a depth-truncated view of the SAME model as"
                         " the draft (its first N layers; the views alias the loaded weights)")
    ap.add_argument("-ts", "--tensor-split", default="1", metavar="N|auto", dest="mesh_model",
                    help="shard the model over N ranks, one a device (the reference's"
                         " --tensor-split, as a mesh 'model' axis size); 'auto' picks the smallest"
                         " split whose per-card footprint fits the card's memory")
    ap.add_argument("--kv-shard", default="heads", choices=["heads", "sequence"],
                    help="KV sharding over the ranks: 'heads' (tensor parallel) or 'sequence'"
                         " (the cache split along time for long contexts; weights whole)")
    ap.add_argument("--multihost", action="store_true",
                    help="join the world torchrun's environment describes (MASTER_ADDR, RANK,"
                         " WORLD_SIZE, LOCAL_RANK) instead of starting the ranks here")
    ap.add_argument("--verbose-timings", action="store_true")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of generation (Chrome trace JSON) to DIR")
    ap.add_argument("-dt", "--debug-timings", type=int, default=0, metavar="LEVEL",
                    choices=[0, 1, 2, 3],
                    help="print a per-op timing table after generation (1 = top 10 ops, 2 = top"
                         " 30, 3 = all; the reference's falcon_main -dt)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def refusal(args) -> str | None:
    """Why a flag the port accepts cannot run, or None."""
    if args.mesh_model != "1" or args.multihost:
        if args.draft_model or args.self_draft:
            return "speculative decoding requires a single-device engine"
        if args.grammar or args.grammar_file:
            return "grammar requires a single-device engine"
    return None


def mtest(engine) -> None:
    """The reference's --mtest: the worst-case paths (a full-batch prefill of
    zeros and one single-token step), their timings, and the card's memory
    allocated and at its peak."""
    import torch

    cfg = engine.cfg
    engine.eval([0] * min(cfg.n_batch, cfg.n_ctx - 1))
    engine.eval([0])
    print(engine.timings.report(), file=sys.stderr)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
        print(f"mtest: {torch.cuda.memory_allocated(engine.device) / 2**20:.1f} MiB allocated,"
              f" peak {torch.cuda.max_memory_allocated(engine.device) / 2**20:.1f} MiB",
              file=sys.stderr)
    else:
        print("mtest: no device memory figure: the engine runs on the CPU", file=sys.stderr)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    why = refusal(args)
    if why:
        print(f"error: {why}", file=sys.stderr)
        return 1
    if args.multihost:
        from ggllm_tpu_torch.parallel import mesh as mesh_mod

        mesh_mod.init_distributed(device=args.device)
        n = (int(args.mesh_model) if args.mesh_model not in ("1", "auto")
             else mesh_mod.dist.get_world_size())
        try:
            mesh = mesh_mod.make_mesh(1, n)
            if mesh is None:  # a rank beyond the mesh
                return 0
            return _quiet_rank(mesh, lambda: _run(parser, args, mesh))
        finally:
            mesh_mod.dist.destroy_process_group()
    if args.mesh_model == "auto":
        from ggllm_tpu_torch.io.ggcc import read_model
        from ggllm_tpu_torch.parallel.plan import device_memory, suggest_tensor_split

        cfg = EngineConfig(n_ctx=args.ctx_size, n_batch=args.batch_size,
                           kv_dtype=args.kv_dtype, compute_dtype=args.compute_dtype)
        plan = suggest_tensor_split(read_model(args.model), cfg,
                                    hbm_bytes=device_memory(args.device))
        args.mesh_model, args.kv_shard = str(plan.model_axis), plan.kv_shard
        print(f"auto tensor split: {plan.model_axis} chip(s), kv_shard={plan.kv_shard}"
              f" ({plan.per_chip_bytes / 2**30:.2f} GB/chip)", file=sys.stderr)
    n = int(args.mesh_model)
    if n > 1:
        return _spawn_ranks(argv, args, n)
    return _run(parser, args, None)


def _devices(args, n: int) -> list[str]:
    """One device a rank: the CPU for each with --device cpu, else this
    host's cards (make_mesh refuses more ranks than there are)."""
    import torch

    if args.device == "cpu":
        return ["cpu"] * n
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def _spawn_ranks(argv, args, n: int) -> int:
    """-ts N on this host: this process is rank 0 (stdin, stdout), ranks 1
    .. N - 1 are spawned processes running the same command line."""
    import shutil

    from ggllm_tpu_torch.parallel import mesh as mesh_mod

    argv = list(sys.argv[1:] if argv is None else argv)
    resolved = {"mesh_model": str(n), "kv_shard": args.kv_shard}  # -ts auto's choice
    try:
        world = mesh_mod.spawn_ranks(n, _devices(args, n), _rank_entry, (argv, resolved),
                                     start=1)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        mesh = _join(world, 0)
        print(f"mesh: 1 x {n} (kv_shard={args.kv_shard}, {world.backend})", file=sys.stderr)
        rc = _run(build_parser(), args, mesh)
        for p in world.procs:
            p.join()
        return rc if all(p.exitcode == 0 for p in world.procs) else 1
    finally:
        for p in world.procs:
            if p.is_alive():
                p.kill()
        if mesh_mod.dist.is_initialized():
            mesh_mod.dist.destroy_process_group()
        shutil.rmtree(world.dir, ignore_errors=True)


def _join(world, rank: int):
    from ggllm_tpu_torch.parallel import mesh as mesh_mod

    world.join(rank)
    return mesh_mod.make_mesh(1, world.n, devices=world.devices)


def _rank_entry(world, rank: int, argv, resolved: dict) -> None:
    """Rank `rank` of -ts N: the same command line (with rank 0's -ts auto
    choice), quiet."""
    parser = build_parser()
    args = parser.parse_args(argv)
    vars(args).update(resolved)
    mesh = _join(world, rank)
    rc = _quiet_rank(mesh, lambda: _run(parser, args, mesh))
    sys.exit(rc)


def _quiet_rank(mesh, run) -> int:
    """run() on this rank; a rank other than 0 prints nothing (its
    stdout and stderr go nowhere) but the traceback of a failure."""
    import os
    import traceback

    if mesh.rank == 0:
        return run()
    err = sys.stderr
    with open(os.devnull, "w") as null:
        sys.stdout = sys.stderr = null
        try:
            return run()
        except BaseException:
            err.write(f"rank {mesh.rank}:\n{traceback.format_exc()}")
            return 1
        finally:
            sys.stdout, sys.stderr = sys.__stdout__, err


def _run(parser, args, mesh) -> int:
    """The CLI's work on one rank (mesh None: the single-process CLI)."""
    if mesh is not None and args.seed < 0:
        # every rank must draw the same ids (the host cascade's draws too)
        # and pick the same --random-prompt: rank 0's seed on every rank
        import random

        args.seed = mesh.comm.broadcast_object(
            random.SystemRandom().randrange(2**32) if mesh.rank == 0 else None)
    if args.interactive_first:
        args.interactive = True
    if args.memory_f32:
        args.kv_dtype = "float32"
    if args.system_file:
        with open(args.system_file, "rb") as f:
            args.sys_prompt = f.read().decode("utf-8", errors="replace")
    if args.ctx_size < 8:
        print("warning: minimum context size is 8", file=sys.stderr)
        args.ctx_size = 8
    # large-context default-temperature derating (falcon_main.cpp:110-125
    # intent: offset the perplexity increase at long NTK-scaled contexts;
    # only when the user left --temp at its default)
    if args.temp == parser.get_default("temp"):
        for ctx, t in ((16384, 0.5), (8192, 0.6), (4096, 0.7)):
            if args.ctx_size >= ctx:
                print(f"info: context size {args.ctx_size} is large; reducing default"
                      f" temperature to {t}", file=sys.stderr)
                args.temp = t
                break

    cfg = EngineConfig(n_ctx=args.ctx_size, n_batch=args.batch_size, kv_dtype=args.kv_dtype,
                       compute_dtype=args.compute_dtype, decode_chunk=args.decode_chunk,
                       weight_mode=args.weight_mode, kv_shard=args.kv_shard)
    t0 = time.perf_counter()
    mf, params = load_model(args.model, cfg, device=args.device, lora=args.lora,
                            lora_base=args.lora_base, mesh=mesh)
    tk = tok_mod.for_model(mf)
    engine = FalconEngine(mf.hparams, params, cfg, device=args.device, mesh=mesh)
    engine.timings.t_load_us = (time.perf_counter() - t0) * 1e6
    if args.alias:
        print(f"model alias: {args.alias}", file=sys.stderr)
    vocab = mf.vocab
    if args.mtest:
        mtest(engine)
        return 0
    if args.export:
        with open(args.export, "w") as f:
            f.write(str(engine.export()))
        print(f"forward graph (torch.export) exported to {args.export}", file=sys.stderr)
        return 0

    sampler = SamplerParams(
        temp=args.temp, top_k=args.top_k, top_p=args.top_p, tfs_z=args.tfs,
        typical_p=args.typical, repeat_penalty=args.repeat_penalty,
        repeat_last_n=args.repeat_last_n, frequency_penalty=args.frequency_penalty,
        presence_penalty=args.presence_penalty, mirostat=args.mirostat,
        mirostat_tau=args.mirostat_tau, mirostat_eta=args.mirostat_eta,
        penalize_nl=not args.no_penalize_nl, logit_bias=parse_logit_bias(args.logit_bias),
        seed=args.seed)

    prompt = args.prompt
    if args.file:
        with open(args.file, "rb") as f:
            prompt = f.read().decode("utf-8", errors="replace")
    if args.random_prompt and not prompt:
        import random

        prompt = random.Random(args.seed if args.seed >= 0 else None).choice(RANDOM_PROMPTS)
    if args.sys_prompt and args.system_raw:
        prompt = args.sys_prompt + prompt

    finetune = detect_finetune(args.model, vocab) if args.finetune == "auto" else args.finetune
    if args.enclose_prompt or args.instruct:
        prompt = build_prompt(finetune, prompt, None if args.system_raw else args.sys_prompt)
    stopwords = finetune_stopwords(finetune)
    if args.stopwords is not None:
        stopwords = [s for s in args.stopwords.split("|") if s]
    print(f"finetune: {finetune}; stopwords: {stopwords}", file=sys.stderr)

    prompt_ids = tk.tokenize(prompt, bos=not prompt.startswith("<|endoftext|>")) or [tk.bos_id]

    def verbose_tokens(ids, label):
        # falcon_main.cpp:542-555 "number of tokens in prompt" dump
        if not args.verbose_prompt:
            return
        print(f"{label}: {len(ids)} tokens", file=sys.stderr)
        for tid in ids:
            s = tk.piece(tid).decode("utf-8", errors="replace")
            s = s.replace("\n", "\\n").replace("\r", "\\r")
            print(f"{tid:6d} -> '{s}'", file=sys.stderr)

    verbose_tokens(prompt_ids, "prompt")

    if args.embedding:
        emb = engine.embed(prompt_ids)
        print(" ".join(f"{v:.6f}" for v in emb))
        return 0

    if args.perplexity:
        # falcon_main's --perplexity mode delegates to the perplexity
        # protocol over the -f text (falcon_perplexity.cpp:28-115)
        from ggllm_tpu_torch.engine.perplexity import perplexity

        res = perplexity(engine, tk.tokenize(prompt, bos=True))
        print(f"perplexity: {res.ppl:.4f} [{res.n_chunks} chunks, {res.count} tokens]")
        return 0

    def set_color(code: str):
        if args.color:
            sys.stdout.write(code)
            sys.stdout.flush()

    if args.ignore_eos:
        sampler.logit_bias[tk.eos_id] = float("-inf")
    # keep the whole prompt on context swap when requested (reference
    # falcon_main: n_keep < 0 or instruct mode -> full prompt)
    n_keep = len(prompt_ids) if (args.n_keep < 0 or args.instruct) else args.n_keep

    if args.draft_model or args.self_draft:
        if args.interactive or args.instruct or args.prompt_cache:
            print("error: speculative decoding supports plain generation only (no"
                  " interactive/instruct/session modes)", file=sys.stderr)
            return 1
        return _speculative(args, mf, params, cfg, engine, tk, prompt, prompt_ids, sampler,
                            stopwords, set_color)

    # session reuse (--prompt-cache): skip the matching prefix
    eval_ids = list(prompt_ids)
    if args.prompt_cache:
        eval_ids = session_mod.try_load(args.prompt_cache, engine, prompt_ids)
        reused = len(prompt_ids) - len(eval_ids)
        if reused:
            print(f"session: reused {reused} prompt tokens", file=sys.stderr)
    grammar = None
    if args.grammar or args.grammar_file:
        from ggllm_tpu_torch.ops.grammar import GrammarSampler, parse_gbnf

        text = args.grammar
        if args.grammar_file:
            with open(args.grammar_file) as f:
                text = f.read()
        grammar = GrammarSampler(parse_gbnf(text), vocab.id_to_token, tk.eos_id)
    gen = Generator(engine, sampler, tk.eos_id, n_keep, fused_ok=not args.no_fused_decode,
                    log=lambda m: print(f"\n[{m}]", file=sys.stderr), grammar=grammar)
    if args.prompt_cache:
        # the host rng, mu and the device generator from the session, so a
        # sampled continuation reproduces (falcon_copy_state_data rng parity,
        # libfalcon.cpp:4254); the generator exists before the first save
        gen.state, gen.rng, _ = session_mod.load_sampler_state(args.prompt_cache, sampler, engine)
    gen.all_tokens = list(prompt_ids[:len(prompt_ids) - len(eval_ids)])
    stop_suffixes = [s.encode() for s in stopwords]
    # the bytes given on the command line, also where they are no UTF-8
    antiprompts = [a.encode("utf-8", "surrogateescape") for a in args.reverse_prompt]

    set_color(ANSI_PROMPT)
    sys.stdout.buffer.write(prompt.encode())
    sys.stdout.flush()
    set_color(ANSI_RESET)
    if args.debug_timings and not args.profile:
        args.profile = tempfile.mkdtemp(prefix="ggllm_dt_")
    prof = start_profile(engine) if args.profile else None
    logits = gen.prefill(eval_ids)
    if args.prompt_cache and not args.prompt_cache_ro and len(eval_ids) > 1:
        # cache the evaluated prompt at once (falcon_main.cpp:867-871 saves at
        # the first sample), so that an interrupted run still reuses it
        session_mod.save(args.prompt_cache, engine, gen.all_tokens[:engine.n_past],
                         sampler_state=gen.state, generator=gen.rng)

    def run_turn(logits):
        ss = StopStream(stop_suffixes, antiprompts)

        def on_token(tok: int) -> bool:
            out = ss.push(tk.piece(tok))
            if out:
                sys.stdout.buffer.write(out)
                sys.stdout.flush()
            return not ss.stopped

        reason = gen.generate(logits, args.n_predict, on_token)
        if not ss.stopped:
            tail = ss.flush()
            if tail:
                sys.stdout.buffer.write(tail)
                sys.stdout.flush()
        print()
        return reason

    # prefill logits not yet consumed by a generation turn (interactive-first
    # defers the first turn until the user has spoken — or pressed Enter)
    pending_logits = None
    if args.interactive_first:
        pending_logits = logits
    else:
        run_turn(logits)

    if args.interactive:
        control = (
            " - To submit your input, end it with '\\'.\n"
            if args.multiline_input else
            " - Return submits; a trailing '\\' continues on another line;\n"
            "   a trailing '/' submits without the final newline.\n")
        print("== Running in interactive mode. ==\n"
              " - An empty input continues the generation; Ctrl+D exits.\n"
              + control, file=sys.stderr)
        while True:
            set_color(ANSI_USER)
            if args.in_prefix:
                sys.stdout.write(args.in_prefix)
                sys.stdout.flush()
            line = read_user_input(args.multiline_input) if mesh is None or mesh.rank == 0 else None
            if mesh is not None:  # rank 0 owns stdin
                line = mesh.comm.broadcast_object(line)
            set_color(ANSI_RESET)
            if line is None:
                break
            if line.strip():
                text = args.in_prefix + line + args.in_suffix
                if args.in_suffix:
                    sys.stdout.write(args.in_suffix)
                    sys.stdout.flush()
                if args.instruct:
                    text = build_prompt(finetune, text, None)
                ids = tk.tokenize(text)
                verbose_tokens(ids, "input")
                logits = gen.prefill(ids)
            elif pending_logits is not None:
                # interactive-first + empty input: generate from the prompt
                logits = pending_logits
            elif gen.pending_feed:
                logits = gen.prefill([])  # continue the generation
            else:
                continue
            pending_logits = None
            run_turn(logits)

    if prof is not None:
        stop_profile(prof, args.profile, args.debug_timings)
    if args.prompt_cache and args.prompt_cache_all and not args.prompt_cache_ro:
        # --prompt-cache-all: the final save includes the generated ids
        # (falcon_main.cpp:1228-1231)
        if gen.swapped:
            print("session: not saved (context swap invalidated the cache)", file=sys.stderr)
        else:
            session_mod.save(args.prompt_cache, engine, gen.all_tokens[:engine.n_past],
                             sampler_state=gen.state, generator=gen.rng)
    print(engine.timings.report(), file=sys.stderr)
    return 0


def start_profile(engine):
    """A running torch.profiler over the host's operators and, on the card,
    its kernels (CUDA graph replays' kernels included)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if engine.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_profile(prof, out_dir: str, level: int) -> None:
    """Stop the profiler, write its Chrome trace into out_dir, and with
    level > 0 print the op table (utils/traceview.py) to stderr."""
    from ggllm_tpu_torch.utils import traceview

    prof.stop()
    path = Path(out_dir) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    print(f"profiler trace written to {path}", file=sys.stderr)
    if level:
        try:
            print(traceview.format_table(traceview.load_op_stats(str(path)), level),
                  file=sys.stderr)
        except (OSError, ValueError) as e:
            print(f"debug-timings: could not parse the trace: {e}", file=sys.stderr)


def _speculative(args, mf, params, cfg, engine, tk, prompt, prompt_ids, sampler, stopwords,
                 set_color) -> int:
    """--draft-model / --self-draft: plain generation through
    engine/speculative.py, the acceptance report on stderr."""
    import dataclasses

    from ggllm_tpu_torch.engine.speculative import SpeculativeDecoder, truncate_params

    t0 = time.perf_counter()
    if args.self_draft:
        if not 0 < args.self_draft < mf.hparams.n_layer:
            print(f"error: --self-draft must be in 1..{mf.hparams.n_layer - 1}", file=sys.stderr)
            return 1
        dhp = dataclasses.replace(mf.hparams, n_layer=args.self_draft)
        draft = FalconEngine(dhp, truncate_params(params, args.self_draft), cfg,
                             device=args.device)
        print(f"self-draft: first {args.self_draft}/{mf.hparams.n_layer} layers (weights"
              " aliased)", file=sys.stderr)
    else:
        dmf, dparams = load_model(args.draft_model, cfg, device=args.device)
        draft = FalconEngine(dmf.hparams, dparams, cfg, device=args.device)
        print(f"draft model loaded in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    spec = SpeculativeDecoder(engine, draft, k=args.draft_k)
    ss = StopStream([s.encode() for s in stopwords],
                    [a.encode("utf-8", "surrogateescape") for a in args.reverse_prompt])
    set_color(ANSI_PROMPT)
    sys.stdout.buffer.write(prompt.encode())
    sys.stdout.flush()
    set_color(ANSI_RESET)

    def on_tok(tok: int):
        out = ss.push(tk.piece(tok))
        if out:
            sys.stdout.buffer.write(out)
            sys.stdout.flush()
        return not ss.stopped

    spec.generate(prompt_ids, args.n_predict, sampler, stop_ids={tk.eos_id}, on_token=on_tok)
    if not ss.stopped:
        tail = ss.flush()
        if tail:
            sys.stdout.buffer.write(tail)
            sys.stdout.flush()
    print()
    print(spec.stats.report(), file=sys.stderr)
    print(engine.timings.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
