"""Grammar-constrained decoding in the port (ggllm_tpu_torch/ops/grammar.py,
the masked chunks of engine/engine.py decode_chunk_masked, the Generator's
grammar paths, the CLI's --grammar / --grammar-file) against the JAX
package's, on the CPU.

The port's copy of ops/grammar.py must compile the grammar texts of
tests/test_grammar.py (the JSON grammar included) to the JAX parser's rules,
accept and reject the same strings, raise GrammarError on the same bad
inputs, and give the JAX GrammarSampler's valid_bits byte for byte along a
seeded walk of accepted tokens. The device unpack of those bits must be
np.unpackbits(bitorder="little"). Greedy grammar ids of the port's
Generator (masked device chunks and the host route) must equal the JAX
Generator's on both its device and host paths, on a tiny Falcon (f32 dense
and int8 caches) and a tiny LLaMA; sampled masked draws must equal the
host cascade over filter_logits on the same uniforms; a C-step masked
chunk rolled back must leave n_past and the cache as 1-step chunks leave
them; and the CLI must print what the JAX CLI prints."""

import numpy as np
import pytest
import torch

from ggllm_tpu.core.config import EngineConfig, FalconHParams, LlamaHParams
from ggllm_tpu.core.dtypes import GGMLType
from ggllm_tpu.engine.engine import FalconEngine as JEngine
from ggllm_tpu.engine.generator import Generator as JGenerator
from ggllm_tpu.io.ggcc import read_model
from ggllm_tpu.io.loader import load_params
from ggllm_tpu.ops import grammar as jgrammar
from ggllm_tpu.ops.sampling import SamplerParams
from ggllm_tpu.tools import main as jcli
from ggllm_tpu.utils import synthetic as jsynthetic

from ggllm_tpu_torch.core.config import EngineConfig as TEngineConfig
from ggllm_tpu_torch.engine.engine import FalconEngine
from ggllm_tpu_torch.engine.generator import Generator
from ggllm_tpu_torch.io.loader import load_model
from ggllm_tpu_torch.ops import grammar, kvcache
from ggllm_tpu_torch.ops import sampling as tsm
from ggllm_tpu_torch.ops import sampling_device as tsd
from ggllm_tpu_torch.ops.sampling import SamplerParams as TSamplerParams
from ggllm_tpu_torch.tools import main as cli
from ggllm_tpu_torch.utils import synthetic as tsynthetic

# pytest-xdist runs several test processes on the machine's cores at once: one
# torch thread each, or their OpenMP threads spin against each other
torch.set_num_threads(1)

JSON_GBNF = r"""
root   ::= object
value  ::= object | array | string | number | "true" | "false" | "null"
object ::= "{" ws ( member ( "," ws member )* )? "}" ws
member ::= string ":" ws value
array  ::= "[" ws ( value ( "," ws value )* )? "]" ws
string ::= "\"" char* "\"" ws
char   ::= [^"\\\x00-\x1f] | "\\" (["\\/bfnrt] | "u" [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F])
number ::= "-"? [0-9]+ ("." [0-9]+)? ws
ws     ::= [ \t\n]*
"""
CHESS = ('# chess move\nroot ::= move (" " move)*\n'
         'move ::= [a-h] [1-8] [a-h] [1-8] ("q"|"r"|"b"|"n")?')
# (grammar text, strings) from tests/test_grammar.py: each string is accepted
# or rejected alike by both parsers
GRAMMARS = [
    ('root ::= "ab" "c"', ["abc", "ab", "abcd", "abd"]),
    ('root ::= ("x" | "yz") "!"', ["x!", "yz!", "y!", "xyz!"]),
    ("root ::= [a-cx] [^0-9]", ["aq", "bq", "cq", "xq", "dq", "a5"]),
    ('root ::= "a"* "b"+ "c"?', ["b", "ab", "aaabb", "bc", "aabbbc", "", "a", "ac", "cb", "bcc"]),
    ("root ::= expr\nexpr ::= term (\"+\" term)*\nterm ::= [0-9]+ | \"(\" expr \")\"",
     ["1", "12+3", "(1+2)+(3)", "((7))", "", "+1", "(1", "1+", "1++2"]),
    ('# header comment\nroot ::= "\\"" [\\t\\-a] "\\n"  # trailing\n',
     ['"\t\n', '"-\n', '"a\n', '"b\n']),
    ('root ::= [\\x41-\\x43] "\\u00e9"', ["Aé", "Cé", "Dé"]),
    ('root ::= "<" . ">"', ["<a>", "<é>", "<>"]),
    ('root ::= "a" | ', ["", "a", "b"]),
    ('root ::= "a"\n  | "b"\n  | "c"', ["a", "b", "c", "d"]),
    ("root ::= [0-9]+", ["0", "123", "", "1a"]),
    ('root ::= "yes" | "no"', ["yes", "no", "ye", "nope"]),
    (JSON_GBNF, ['{}', '{"a":1}', '{"a": [1, 2.5, {"b":"c\\n"}], "d": null}', '', '{',
                 '{"a"}', '{"a":}', "{'a':1}", '{"a":1,}', '[]']),
    (CHESS, ["e2e4 e7e8q", "i2e4", "e2e4 "]),
]
BAD = ['root ::= "unterminated', "root ::= [z-a]", "root ::= undefined-rule", 'other ::= "x"',
       'root ::= "a"\nroot ::= "b"', 'root ::= root "a" | "b"', "root ::= (\"a\"", "root ::= []",
       'root ::= "\\q"', "ro ot ::= \"a\"", "root ::= \"a\" )", "no rule here"]
DIGITS = "root ::= [0-9]+"


def _accepts(mod, g, text: str):
    stacks = g.start()
    for ch in text:
        stacks = g.advance(stacks, ord(ch))
        if not stacks:
            return False, False
    return True, mod.Grammar.can_complete(stacks)


@pytest.mark.parametrize("idx", range(len(GRAMMARS)))
def test_parse_gbnf_matches_jax(idx):
    """Both parsers compile a grammar to the same rules, names and root, and
    agree on every string (a viable prefix, and a complete parse)."""
    text, strings = GRAMMARS[idx]
    g, jg = grammar.parse_gbnf(text), jgrammar.parse_gbnf(text)
    assert g.rules == jg.rules and g.names == jg.names and g.root == jg.root
    for s in strings:
        assert _accepts(grammar, g, s) == _accepts(jgrammar, jg, s), s


@pytest.mark.parametrize("text", BAD)
def test_bad_grammars_raise_like_jax(text):
    with pytest.raises(jgrammar.GrammarError) as jerr:
        jgrammar.parse_gbnf(text)
    with pytest.raises(grammar.GrammarError) as err:
        grammar.parse_gbnf(text)
    assert str(err.value) == str(jerr.value)


def test_a_bad_hex_escape_is_a_grammar_error():
    """A \\x escape with a non-hex digit: the JAX parser lets int()'s
    ValueError out (its server answers 500), the port's raises GrammarError
    (its servers answer 400)."""
    text = 'root ::= "\\x4"'
    with pytest.raises(ValueError) as jerr:
        jgrammar.parse_gbnf(text)
    assert not isinstance(jerr.value, jgrammar.GrammarError)
    with pytest.raises(grammar.GrammarError, match="bad .x escape"):
        grammar.parse_gbnf(text)


VOCABS = {"falcon": lambda: tsynthetic.make_tiny_vocab(65024),
          "falcon_512": lambda: tsynthetic.make_tiny_vocab(512),
          "llama_sp": lambda: tsynthetic.make_tiny_sp_vocab(512)}
EOS = {"falcon": 11, "falcon_512": 11, "llama_sp": 2}


@pytest.mark.parametrize("vocab,text", [
    ("falcon", DIGITS), ("falcon", CHESS), ("falcon_512", JSON_GBNF),
    ("falcon_512", 'root ::= "é" [a-z]+ " " [^a]*'), ("llama_sp", JSON_GBNF),
    ("llama_sp", CHESS)])
def test_valid_bits_match_jax_along_a_walk(vocab, text):
    """valid_bits of the port's GrammarSampler is byte-equal to the JAX
    sampler's (and both are np.packbits of valid_token_ids, little-endian,
    ceil(V / 8) bytes) at every state of a seeded walk of accepted tokens;
    filter_logits is equal too."""
    pieces = VOCABS[vocab]().id_to_token
    eos = EOS[vocab]
    gs = grammar.GrammarSampler(grammar.parse_gbnf(text), pieces, eos)
    jgs = jgrammar.GrammarSampler(jgrammar.parse_gbnf(text), pieces, eos)
    rng = np.random.default_rng(len(text))
    logits = rng.standard_normal(len(pieces)).astype(np.float32)
    for _ in range(24):
        bits = gs.valid_bits()
        assert bits.dtype == np.uint8 and bits.shape == (tsd.mask_bytes(len(pieces)),)
        np.testing.assert_array_equal(bits, jgs.valid_bits())
        np.testing.assert_array_equal(gs.filter_logits(logits), jgs.filter_logits(logits))
        ids = gs.valid_token_ids()
        tok = int(rng.choice(ids[ids != eos])) if (ids != eos).any() else eos
        if tok == eos:
            break
        gs.accept(tok)
        jgs.accept(tok)
        assert (gs.stacks, gs.partial) == (jgs.stacks, jgs.partial)
    valid = set(gs.valid_token_ids().tolist())
    with pytest.raises(grammar.GrammarError):
        gs.accept(next(t for t in range(len(pieces)) if t not in valid and t != eos))


@pytest.mark.parametrize("V,lead", [(65024, ()), (37, (3,)), (8, (2, 5))])
def test_device_unpack_is_numpys(V, lead):
    """apply_grammar_mask unpacks little-endian bits as np.unpackbits(...,
    bitorder="little") does and sets the invalid logits to -inf."""
    rng = np.random.default_rng(V)
    bits = rng.integers(0, 256, (*lead, tsd.mask_bytes(V)), dtype=np.uint8)
    logits = rng.standard_normal((*lead, V)).astype(np.float32)
    got = tsd.apply_grammar_mask(torch.from_numpy(logits), torch.from_numpy(bits)).numpy()
    valid = np.unpackbits(bits, axis=-1, bitorder="little")[..., :V].astype(bool)
    np.testing.assert_array_equal(got, np.where(valid, logits, -np.inf))


@pytest.mark.parametrize("temp,top_k,top_p,rp", [(0.8, 40, 0.95, 1.1), (1.2, 8, 1.0, 1.3),
                                                 (0.5, 64, 0.7, 1.0)])
def test_sampled_masked_draw_is_the_host_cascade(temp, top_k, top_p, rp):
    """The masked single-stream draw (apply_penalties under a masked key,
    then sample_logits on a uniform u) gives the host cascade's id over
    filter_logits replaying u, and the masked row step gives it too."""
    V = 512
    pieces = tsynthetic.make_tiny_vocab(V).id_to_token
    gs = grammar.GrammarSampler(grammar.parse_gbnf(DIGITS), pieces, 11)
    gs.accept(pieces.index(b"7"))
    bits = gs.valid_bits()
    rng = np.random.default_rng(9)
    logits = (rng.standard_normal(V) * 3).astype(np.float32)
    hist = [int(t) for t in rng.integers(12, V, 20)] + [pieces.index(b"7"), pieces.index(b"3")]
    params = TSamplerParams(temp=temp, top_k=top_k, top_p=top_p, repeat_penalty=rp,
                            repeat_last_n=16)
    key = tsd.sampler_key(params, V, 193, masked=True)
    sv = tsd.SamplerValues(key, "cpu", V).set(params, V).set_mask(bits)
    ring = torch.tensor(hist[-16:])
    rkey = tsd.RowKey(64, 16, 0, False, True)
    rv = tsd.RowValues(rkey, 1, "cpu", V).set(
        {"temp": np.array([temp]), "top_p": np.array([top_p]), "top_k": np.array([top_k]),
         "repeat_penalty": np.array([rp])}, np.zeros((1, 0)), np.zeros((1, 0)), [10.0],
        bits[None])
    t = torch.from_numpy(logits)
    for u in np.linspace(0.02, 0.98, 9).astype(np.float32):
        got = int(tsd.sample_logits(tsd.apply_penalties(t, ring, key, sv), key, sv,
                                    torch.tensor(u)))
        state = tsm.SamplerState(rng=_Replay(float(u)), mu=10.0)
        ref = tsm.sample(gs.filter_logits(logits), hist, params, state, nl_token=193)
        row = int(tsd.sample_rows_step(t[None], ring[None], rkey, rv, torch.tensor([u]), 193)[0])
        assert got == ref == row, u
        assert pieces[got].isdigit() or got == 11


class _Replay:
    def __init__(self, u):
        self.u = u

    def random(self):
        return self.u


def _cfg(cls, kv_dtype="float32"):
    return cls(n_ctx=96, n_batch=32, kv_dtype=kv_dtype, compute_dtype="float32")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("grammar")
    falcon, llama = str(d / "falcon.ggcc"), str(d / "llama.ggjt")
    jsynthetic.write_tiny_model(falcon, FalconHParams.tiny(), ftype_2d=GGMLType.Q8_0, seed=11)
    jsynthetic.write_tiny_llama(llama, LlamaHParams.tiny(), ftype_2d=GGMLType.Q8_0, seed=13)
    return {"falcon": falcon, "llama": llama}


# (family, kv_dtype, sampler keywords, grammar, tokens): the JAX tests' cases
# (the digit runs ban the end of text, so that they run long enough for
# C-step chunks)
CASES = {
    "falcon_f32": ("falcon", "float32", dict(temp=0.0, repeat_penalty=1.1,
                                             logit_bias={11: float("-inf")}), DIGITS, 24),
    "falcon_f32_json": ("falcon", "float32", dict(temp=0.0, repeat_penalty=1.0), JSON_GBNF, 24),
    "falcon_int8": ("falcon", "int8", dict(temp=0.0, repeat_penalty=1.0,
                                           logit_bias={11: float("-inf")}), DIGITS, 24),
    "llama_f32": ("llama", "float32", dict(temp=0.0, repeat_penalty=1.0,
                                           logit_bias={2: float("-inf")}), DIGITS, 22),
}
PROMPT = [5, 17, 130]


def _run_generator(gen_cls, g_mod, eng, vocab, eos, case, device: bool):
    _, _, kw, text, n = CASES[case]
    sampler_cls = SamplerParams if g_mod is jgrammar else TSamplerParams
    gs = g_mod.GrammarSampler(g_mod.parse_gbnf(text), vocab.id_to_token, eos)
    gen = gen_cls(eng, sampler_cls(**kw), eos, grammar=gs)
    gen.grammar_device = device
    toks = []
    gen.generate(gen.prefill(PROMPT), n, lambda t: toks.append(t) or True)
    return toks, gen


@pytest.fixture(scope="module")
def jax_ids(files):
    """The JAX Generator's greedy grammar ids of CASES on its device and host
    paths, once a module (one JAX engine a file and cache)."""
    out, engines = {}, {}
    for case, (family, kv_dtype, _, _, _) in CASES.items():
        mf = read_model(files[family])
        if (family, kv_dtype) not in engines:
            cfg = _cfg(EngineConfig, kv_dtype)
            engines[family, kv_dtype] = JEngine(mf.hparams, load_params(mf, cfg), cfg)
        eng = engines[family, kv_dtype]
        for device in (True, False):
            eng.reset()
            out[case, device] = _run_generator(JGenerator, jgrammar, eng, mf.vocab,
                                               2 if family == "llama" else 11, case, device)[0]
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_generator_grammar_ids_match_jax(files, jax_ids, case):
    """The port's Generator under a grammar, greedy: the masked device
    chunks (1-step while the state changes, C-step chunks rolled back at
    the first change once it loops) and the host route give the JAX
    Generator's ids on its device and its host paths, and every id extends
    the grammar."""
    family, kv_dtype, _, text, n = CASES[case]
    mf, params = load_model(files[family], _cfg(TEngineConfig, kv_dtype), device="cpu")
    eos = 2 if family == "llama" else 11
    outs = {}
    for device in (True, False):
        eng = FalconEngine(mf.hparams, params, _cfg(TEngineConfig, kv_dtype), device="cpu")
        outs[device], gen = _run_generator(Generator, grammar, eng, mf.vocab, eos, case, device)
        if device and text == DIGITS:
            assert gen.masked_stats["chunks"] and gen.masked_stats["rolled_back"], gen.masked_stats
    assert outs[True] == outs[False] == jax_ids[case, True] == jax_ids[case, False]
    assert len(outs[True]) in range(1, n + 1)
    if text == DIGITS:
        assert all(mf.vocab.id_to_token[t].isdigit() for t in outs[True] if t != eos)
        assert len(outs[True]) == n
    check = grammar.GrammarSampler(grammar.parse_gbnf(text), mf.vocab.id_to_token, eos)
    for t in outs[True]:
        check.accept(t)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_masked_chunk_rollback_is_one_step_chunks(files, kv_dtype):
    """A 6-step masked chunk rolled back after its second id leaves n_past
    and the cache's valid positions as two 1-step chunks leave them (bit for
    bit on a dense cache, whose steps write in place; on an int8 cache,
    whose chunk-deferred steps attend over its earlier steps' unquantized
    K/V, every code within one step and the scales within 1e-3), and the
    ids equal; the next step after either gives the same id."""
    mf, params = load_model(files["falcon"], _cfg(TEngineConfig, kv_dtype), device="cpu")
    vocab = mf.vocab
    gs = grammar.GrammarSampler(grammar.parse_gbnf(DIGITS), vocab.id_to_token, 11)
    first = vocab.id_to_token.index(b"4")
    gs.accept(first)
    bits = gs.valid_bits()
    sampler = TSamplerParams(temp=0.0, repeat_penalty=1.1)

    def engine():
        eng = FalconEngine(mf.hparams, params, _cfg(TEngineConfig, kv_dtype), device="cpu")
        eng.eval(PROMPT)
        return eng

    one = engine()
    start = one.n_past
    ids = [first]
    for _ in range(2):
        got, _ = one.decode_chunk_masked(ids[-1], bits, 1, sampler, last_tokens=PROMPT + ids)
        ids += [int(got[0])]
    chunk = engine()
    got, _ = chunk.decode_chunk_masked(first, bits, 6, sampler, last_tokens=PROMPT + [first])
    assert chunk.n_past == start + 6
    chunk.rollback(start + 2)
    assert list(got[:2]) == ids[1:] and one.n_past == chunk.n_past == start + 2
    if kv_dtype == "float32":
        torch.testing.assert_close(chunk.kv[..., :start + 2, :, :], one.kv[..., :start + 2, :, :],
                                   rtol=0, atol=0)
    else:
        codes, scales = (t[..., :start + 2, :, :] for t in chunk.kv)
        ref_codes, ref_scales = (t[..., :start + 2, :, :] for t in one.kv)
        assert (codes.int() - ref_codes.int()).abs().max() <= 1
        torch.testing.assert_close(scales, ref_scales, rtol=1e-3, atol=0)
        assert kvcache.is_quantized(chunk.kv)
    nxt = [e.decode_chunk_masked(ids[-1], bits, 1, sampler, last_tokens=PROMPT + ids)[0][0]
           for e in (one, chunk)]
    assert nxt[0] == nxt[1]


BASE = ["-c", "96", "-b", "32", "--kv-dtype", "float32", "--compute-dtype", "float32",
        "--temp", "0", "-p", "the", "-n", "8"]


@pytest.mark.parametrize("flag", ["--grammar", "--grammar-file"])
def test_cli_grammar_matches_jax_cli(files, capsysbinary, tmp_path, flag):
    """--grammar and --grammar-file: the port's CLI prints the JAX CLI's
    text (the cases of tests/test_grammar.py:284-300)."""
    arg = DIGITS
    if flag == "--grammar-file":
        arg = str(tmp_path / "g.gbnf")
        (tmp_path / "g.gbnf").write_text('root ::= "yes" | "no"')
    assert cli.main(["-m", files["falcon"], *BASE, "--device", "cpu", flag, arg]) == 0
    got = capsysbinary.readouterr().out
    jcli.main(["-m", files["falcon"], *BASE, flag, arg])
    ref = capsysbinary.readouterr().out
    assert got == ref
    gen = got[len(b"the"):].rstrip(b"\n")
    assert gen.isdigit() if flag == "--grammar" else gen in (b"yes", b"no")
