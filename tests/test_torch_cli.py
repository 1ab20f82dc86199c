"""The port's CLI (ggllm_tpu_torch/tools/main.py) on the CPU against the JAX
CLI (the applicable cases of tests/test_cli.py): the console input
protocol, generate-and-echo with the JAX CLI's output, --interactive-first
with piped input, a context swap under --keep, a reverse prompt (-r), a
prompt file (-f), the host route, and the flags' names and defaults."""

import builtins

import pytest
import torch

from ggllm_tpu.core.config import FalconHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.tools import main as jcli

from ggllm_tpu_torch.tools import main as cli

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

BASE = ["-c", "96", "-b", "32", "--kv-dtype", "float32", "--compute-dtype", "float32",
        "--temp", "0", "--decode-chunk", "4"]

@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    from ggllm_tpu.utils.synthetic import write_tiny_model

    path = str(tmp_path_factory.mktemp("cli") / "tiny.ggcc")
    write_tiny_model(path, FalconHParams.tiny(), ftype_2d=GGMLType.Q8_0, seed=11)
    return path


def run_cli(tiny_model, *extra):
    return cli.main(["-m", tiny_model, *BASE, "--device", "cpu", *map(str, extra)])


def feed_input(monkeypatch, lines):
    it = iter(lines)

    def fake_input(prompt_str=""):
        try:
            return next(it)
        except StopIteration:
            raise EOFError

    monkeypatch.setattr(builtins, "input", fake_input)


@pytest.mark.parametrize("lines, multiline, want", [
    (["hello"], False, "hello\n"),
    (["one\\", "two"], False, "one\ntwo\n"),
    (["tail/"], False, "tail"),
    (["a", "b", "c\\"], True, "a\nb\nc\n"),
    ([], False, None),
    (["partial"], True, "partial\n"),
], ids=["submit", "continue", "no_newline", "multiline", "eof", "eof_partial"])
def test_read_user_input_matches_jax(monkeypatch, lines, multiline, want):
    feed_input(monkeypatch, lines)
    assert cli.read_user_input(multiline) == want
    feed_input(monkeypatch, lines)
    assert jcli.read_user_input(multiline) == want


def test_generate_and_echo_matches_jax_cli(tiny_model, capsysbinary, monkeypatch):
    """The same command line through both CLIs prints the same text (greedy,
    f32, pipelined chunks of 4) and the timing report."""
    monkeypatch.setenv("GGLLM_COMPILE_CACHE", "")
    assert run_cli(tiny_model, "-p", "the", "-n", "12") == 0
    out = capsysbinary.readouterr()
    assert out.out.startswith(b"the") and b"eval time" in out.err
    jcli.main(["-m", tiny_model, *BASE, "-p", "the", "-n", "12"])
    assert capsysbinary.readouterr().out == out.out


def test_no_fused_decode_gives_the_same_text(tiny_model, capsysbinary):
    """--no-fused-decode (the per-token host route) prints what the
    pipelined device route prints, one draw a token."""
    run_cli(tiny_model, "-p", "the", "-n", "10")
    fused = capsysbinary.readouterr().out
    run_cli(tiny_model, "-p", "the", "-n", "10", "--no-fused-decode")
    out = capsysbinary.readouterr()
    assert out.out == fused and b"/ 10 runs" in out.err.split(b"sample time")[1]


def test_interactive_first_waits_for_input(tiny_model, capsysbinary, monkeypatch):
    feed_input(monkeypatch, ["ok"])
    run_cli(tiny_model, "-p", "the", "-n", "2", "--interactive-first",
            "--in-prefix", "Q: ", "--in-suffix", " A:")
    out = capsysbinary.readouterr().out
    # the in-suffix is echoed after the user's line, before generation
    assert b" A:" in out


def test_interactive_first_empty_input_generates(tiny_model, capsysbinary, monkeypatch):
    feed_input(monkeypatch, [""])
    run_cli(tiny_model, "-p", "the", "-n", "3", "--interactive-first")
    out = capsysbinary.readouterr().out
    assert out.startswith(b"the") and len(out) > len(b"the\n")


def test_interactive_empty_line_continues(tiny_model, capsysbinary, monkeypatch):
    """-i: an empty line continues the generation from the pending token,
    as the JAX CLI does: the same text."""
    monkeypatch.setenv("GGLLM_COMPILE_CACHE", "")
    feed_input(monkeypatch, [""])
    run_cli(tiny_model, "-p", "the", "-n", "3", "-i")
    out = capsysbinary.readouterr().out
    feed_input(monkeypatch, [""])
    jcli.main(["-m", tiny_model, *BASE, "-p", "the", "-n", "3", "-i"])
    assert out.startswith(b"the") and capsysbinary.readouterr().out == out


def test_keep_with_a_context_swap_matches_jax(tiny_model, capsysbinary, monkeypatch):
    """-c 32 --keep 4 -n 60: generation runs past the context through
    swaps, and prints the JAX CLI's text."""
    monkeypatch.setenv("GGLLM_COMPILE_CACHE", "")
    args = ["-p", "the thing is", "-n", "60", "--keep", "4", "--ignore-eos"]
    cli.main(["-m", tiny_model, *BASE[2:], "-c", "32", "--device", "cpu", *args])
    out = capsysbinary.readouterr()
    assert b"context swap: kept" in out.err
    jcli.main(["-m", tiny_model, *BASE[2:], "-c", "32", *args])
    assert capsysbinary.readouterr().out == out.out


def test_reverse_prompt_stops_after_it(tiny_model, capsysbinary):
    """-r: generation stops right after the first token that completes the
    antiprompt, which is printed (the bytes of two generated tokens, taken
    from the engine's greedy ids for the same settings)."""
    from ggllm_tpu_torch import tokenizer as ttok
    from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
    from ggllm_tpu_torch.engine.engine import FalconEngine as TFalconEngine
    from ggllm_tpu_torch.io.loader import load_model as tload_model
    from ggllm_tpu_torch.ops.sampling import SamplerParams as TSamplerParams

    cfg = TEngineConfig(n_ctx=96, n_batch=32, kv_dtype="float32", compute_dtype="float32")
    mf, params = tload_model(tiny_model, cfg, device="cpu")
    tk = ttok.for_model(mf)
    eng = TFalconEngine(mf.hparams, params, cfg, device="cpu")
    ids = eng.generate(tk.tokenize("the", bos=True), 24,
                       TSamplerParams(temp=0.0, logit_bias={tk.eos_id: float("-inf")}))
    pieces = [tk.piece(t) for t in ids]
    anti = pieces[9] + pieces[10]
    stop = next(k for k in range(1, len(pieces) + 1) if b"".join(pieces[:k]).endswith(anti))
    run_cli(tiny_model, "-p", "the", "-n", "24", "--ignore-eos")
    assert capsysbinary.readouterr().out == b"the" + b"".join(pieces) + b"\n"
    run_cli(tiny_model, "-p", "the", "-n", "24", "--ignore-eos", "-r",
            anti.decode("utf-8", errors="surrogateescape"))
    assert capsysbinary.readouterr().out == b"the" + b"".join(pieces[:stop]) + b"\n"
    assert stop < len(pieces)


def test_prompt_file(tiny_model, capsysbinary, tmp_path):
    """-f reads the prompt from a file: the same text as -p."""
    (tmp_path / "p.txt").write_text("the cat sat")
    run_cli(tiny_model, "-f", str(tmp_path / "p.txt"), "-n", "4")
    via_file = capsysbinary.readouterr().out
    run_cli(tiny_model, "-p", "the cat sat", "-n", "4")
    assert via_file.startswith(b"the cat sat") and capsysbinary.readouterr().out == via_file


def test_random_prompt_and_verbose_prompt(tiny_model, capsysbinary):
    run_cli(tiny_model, "--random-prompt", "-s", "3", "-n", "2", "--verbose-prompt")
    out = capsysbinary.readouterr()
    assert any(out.out.startswith(p.encode()) for p in cli.RANDOM_PROMPTS)
    assert b"prompt:" in out.err and b"->" in out.err
    assert cli.RANDOM_PROMPTS == jcli.RANDOM_PROMPTS


def test_large_context_derates_the_default_temperature(tiny_model, capsysbinary):
    cli.main(["-m", tiny_model, "-c", "4096", "-n", "1", "--device", "cpu",
              "--compute-dtype", "float32", "--kv-dtype", "float32", "-p", "the"])
    assert b"reducing default temperature to 0.7" in capsysbinary.readouterr().err


def test_logit_bias_parses_as_the_jax_cli():
    specs = ["15043+1.5", "2-inf", "7-0.25", "11+0"]
    assert cli.parse_logit_bias(specs) == jcli.parse_logit_bias(specs)
    with pytest.raises(ValueError):
        cli.parse_logit_bias(["12"])


def test_flags_match_the_jax_cli():
    """Every flag of the port's CLI but --device is a JAX CLI flag with the
    same destination and default, and every JAX CLI flag is the port's."""
    def flags(ap):
        return {o: (a.dest, a.default) for a in ap._actions for o in a.option_strings
                if o not in ("-h", "--help")}

    got, ref = flags(cli.build_parser()), flags(jcli.build_argparser())
    ported = {o: v for o, v in got.items() if o != "--device"}
    assert ported == {o: ref[o] for o in ported}
    for o in ("-f", "--random-prompt", "-b", "--keep", "-l", "--logit-bias", "-r", "-S", "-i",
              "--interactive-first", "-ins", "--in-prefix", "--in-suffix", "--multiline-input",
              "--color", "--sys-prompt", "--system", "--system-file", "--system-raw", "-enc",
              "--finetune", "--verbose-prompt", "--compute-dtype", "--decode-chunk",
              "--no-fused-decode", "--display-timings", "--verbose-timings", "--perplexity",
              "--embedding", "--grammar", "--grammar-file", "--prompt-cache",
              "--prompt-cache-all", "--prompt-cache-ro", "--draft-model", "--draft-k",
              "--self-draft", "--export"):
        assert o in ported, o
    assert set(ported) == set(ref)
