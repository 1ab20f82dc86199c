"""GBNF grammar-constrained sampling, host side (a copy of
ggllm_tpu/ops/grammar.py, which the port does not import).

The GBNF dialect of the llama.cpp ecosystem, so existing grammar files
(JSON, chess, arithmetic) work unchanged:

    root  ::= object
    value ::= object | array | string | number | ("true"|"false"|"null") ws
    ...literals "..", char classes [a-z0-9^], ranges, ( groups ),
    alternation |, postfix * + ?, comments (#), and rule references.

Semantics: at every sampling step tokens whose byte sequence cannot extend
any active parse are masked to -inf BEFORE the sampler cascade (the
llama.cpp llama_sample_grammar ordering), and the end-of-stream token is
allowed only once the grammar can complete. Byte-level BPE tokens may end
mid-UTF-8-codepoint; a partial-bytes tail is carried across tokens and
validated as a feasible UTF-8 prefix, matching llama.cpp's partial_utf8
handling.

Implementation: parse stacks over the compiled rules (each stack is a
tuple of (rule, alternate, position) frames, kept normalized so the top is
always a character matcher), advanced one codepoint at a time; the
per-step vocabulary mask is computed by a depth-first walk of a byte trie
over the token pieces (shared prefixes are checked once) and memoized per
grammar state, so a state that constrained decoding revisits (a digit run,
a string's interior) costs a dict lookup. `valid_bits` is the upload format
of the engine's masked decode (ops/sampling_device.py apply_grammar_mask).
"""

from __future__ import annotations

import numpy as np

__all__ = ["parse_gbnf", "Grammar", "GrammarSampler", "GrammarError"]

_ANY = ((0, 0x10FFFF),)
_MAX_DEPTH = 256  # expansion guard: left-recursive grammars cannot terminate


class GrammarError(ValueError):
    pass


# --------------------------------------------------------------------------
# compiled form: rules[id] = tuple of alternates; alternate = tuple of
# elements; element = ("char", ranges, negated) | ("ref", rule_id)


class Grammar:
    def __init__(self, rules, names, root_id: int):
        self.rules = rules
        self.names = names
        self.root = root_id

    # -------------------------------------------------------- parse stacks

    def start(self) -> frozenset:
        """Initial stack set: the root rule's alternates, normalized."""
        out = set()
        for aid in range(len(self.rules[self.root])):
            out |= self._expand(((self.root, aid, 0),), 0)
        return frozenset(out)

    def _canon(self, stack):
        """Canonical stack: drop INTERIOR epsilon frames — frames whose
        resumption point (pos+1, where a completing child advances them) is
        already past their alternate's end, so they only ever pop through.
        Without this, right-recursive repetition (x+ ≙ x ::= c x | c) piles
        one such frame per matched element: behaviorally identical states
        never compare equal, the per-state mask cache never hits, and state
        size grows O(tokens). With it, self-looping states (digit runs,
        string interiors) are literally equal — which the mask cache and
        the engine's fused masked-chunk path both key on."""
        if len(stack) <= 1:
            return stack
        keep = tuple(
            f for f in stack[:-1]
            if f[2] + 1 < len(self.rules[f[0]][f[1]]))
        return keep + (stack[-1],)

    def _expand(self, stack, depth=0):
        """Normalize: pop exhausted alternates (advancing their parents) and
        expand rule references until the top element is a char matcher or
        the stack is empty (= grammar may complete). Iterative: pop cascades
        can run as deep as the parse stack (right-recursive repetition grows
        it linearly), so only REF expansions count toward the recursion
        guard — a path that expands refs without ever reaching a character
        is left-recursive and cannot terminate."""
        out = set()
        work = [(stack, 0)]  # (stack, refs expanded along this path)
        while work:
            stack, refs = work.pop()
            if not stack:
                out.add(stack)
                continue
            rid, aid, pos = stack[-1]
            seq = self.rules[rid][aid]
            if pos >= len(seq):  # alternate done: advance the parent
                parent = stack[:-1]
                if not parent:
                    out.add(())
                    continue
                prid, paid, ppos = parent[-1]
                work.append((parent[:-1] + ((prid, paid, ppos + 1),), refs))
                continue
            el = seq[pos]
            if el[0] == "char":
                out.add(self._canon(stack))
                continue
            if refs > _MAX_DEPTH:
                raise GrammarError(
                    "grammar expansion too deep (left recursion?)")
            for sub_aid in range(len(self.rules[el[1]])):
                work.append((stack + ((el[1], sub_aid, 0),), refs + 1))
        return out

    def advance(self, stacks: frozenset, cp: int) -> frozenset:
        """All stacks after consuming codepoint cp (empty set = dead end)."""
        out = set()
        for stack in stacks:
            if not stack:
                continue  # a completed parse consumes nothing further
            rid, aid, pos = stack[-1]
            _, ranges, neg = self.rules[rid][aid][pos]
            hit = any(lo <= cp <= hi for lo, hi in ranges)
            if hit != neg:
                out |= self._expand(stack[:-1] + ((rid, aid, pos + 1),), 0)
        return frozenset(out)

    @staticmethod
    def can_complete(stacks: frozenset) -> bool:
        return any(not s for s in stacks)


# --------------------------------------------------------------------------
# GBNF text -> Grammar


def parse_gbnf(text: str, root: str = "root") -> Grammar:
    rules: dict[int, list] = {}
    ids: dict[str, int] = {}

    def rule_id(name: str) -> int:
        if name not in ids:
            ids[name] = len(ids)
        return ids[name]

    def reserve() -> int:
        rid = len(ids)
        ids[f"<aux{rid}>"] = rid
        return rid

    def define(rid: int, alts) -> int:
        rules[rid] = alts
        return rid

    def aux_rule(alts) -> int:
        return define(reserve(), alts)

    # strip comments, then merge continuation lines into their rule line
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if "::=" in line or not lines:
            lines.append(line)
        else:
            lines[-1] += " " + line
    for line in lines:
        if "::=" not in line:
            raise GrammarError(f"expected 'name ::= ...': {line!r}")
        name, body = line.split("::=", 1)
        name = name.strip()
        if not name or not all(c.isalnum() or c in "-_" for c in name):
            raise GrammarError(f"bad rule name {name!r}")
        rid = rule_id(name)
        if rid in rules:
            raise GrammarError(f"duplicate rule {name!r}")
        p = _Parser(body, rule_id, aux_rule, reserve, define)
        rules[rid] = p.alternates()
        if not p.at_end():
            raise GrammarError(f"trailing junk in rule {name!r}: "
                               f"{body[p.i:]!r}")
    if root not in ids:
        raise GrammarError(f"no root rule {root!r}")
    for name, rid in ids.items():
        if rid not in rules:
            raise GrammarError(f"undefined rule {name!r}")
    table = [tuple(map(tuple, rules[r])) for r in range(len(ids))]
    g = Grammar(tuple(table), {v: k for k, v in ids.items()}, ids[root])
    g.start()  # surface left-recursion / emptiness errors at parse time
    return g


def _strip_comment(line: str) -> str:
    out, i, n = [], 0, len(line)
    in_str = in_cls = False
    while i < n:
        c = line[i]
        if c == "\\" and (in_str or in_cls) and i + 1 < n:
            out.append(line[i:i + 2]); i += 2
            continue
        if c == '"' and not in_cls:
            in_str = not in_str
        elif c == "[" and not in_str and not in_cls:
            in_cls = True
        elif c == "]" and in_cls:
            in_cls = False
        elif c == "#" and not in_str and not in_cls:
            break
        out.append(c); i += 1
    return "".join(out)


class _Parser:
    def __init__(self, s: str, rule_id, aux_rule, reserve, define):
        self.s = s
        self.i = 0
        self.rule_id = rule_id
        self.aux = aux_rule
        self.reserve = reserve
        self.define = define

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1

    def at_end(self) -> bool:
        self._ws()
        return self.i >= len(self.s)

    def _peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def alternates(self) -> list:
        alts = [self.sequence()]
        self._ws()
        while self._peek() == "|":
            self.i += 1
            alts.append(self.sequence())
            self._ws()
        return alts

    def sequence(self) -> tuple:
        seq = []
        while True:
            self._ws()
            c = self._peek()
            if c in ("", "|", ")"):
                return tuple(seq)
            seq.append(self.item())

    def item(self):
        el = self.primary()
        self._ws()
        c = self._peek()
        if c and c in "*+?":
            self.i += 1
            if c == "?":
                rid = self.aux([[el], []])
            else:
                star = self.reserve()  # self-referencing: x* ::= x x* | ε
                self.define(star, [[el, ("ref", star)], []])
                rid = star if c == "*" else self.aux([[el, ("ref", star)]])
            return ("ref", rid)
        return el

    def primary(self):
        self._ws()
        c = self._peek()
        if c == '"':
            return self.literal()
        if c == "[":
            return self.char_class()
        if c == "(":
            self.i += 1
            alts = self.alternates()
            self._ws()
            if self._peek() != ")":
                raise GrammarError("unclosed '('")
            self.i += 1
            return ("ref", self.aux(alts))
        if c == ".":
            self.i += 1
            return ("char", _ANY, False)
        if c and (c.isalnum() or c in "-_"):
            j = self.i
            while j < len(self.s) and (self.s[j].isalnum() or self.s[j] in "-_"):
                j += 1
            name = self.s[self.i:j]
            self.i = j
            return ("ref", self.rule_id(name))
        raise GrammarError(f"unexpected {c!r} at {self.i}")

    def literal(self):
        """A quoted string compiles to an aux rule of single-char elements
        (or a single char element for 1-char strings)."""
        assert self._peek() == '"'
        self.i += 1
        chars = []
        while self._peek() != '"':
            if self.i >= len(self.s):
                raise GrammarError("unterminated string literal")
            chars.append(self._char())
        self.i += 1
        els = [("char", ((cp, cp),), False) for cp in chars]
        if not els:
            return ("ref", self.aux([[]]))
        if len(els) == 1:
            return els[0]
        return ("ref", self.aux([els]))

    def char_class(self):
        assert self._peek() == "["
        self.i += 1
        neg = self._peek() == "^"
        if neg:
            self.i += 1
        ranges = []
        while self._peek() != "]":
            if self.i >= len(self.s):
                raise GrammarError("unterminated char class")
            lo = self._char()
            if self._peek() == "-" and self.s[self.i + 1:self.i + 2] != "]":
                self.i += 1
                hi = self._char()
            else:
                hi = lo
            if hi < lo:
                raise GrammarError("inverted range in char class")
            ranges.append((lo, hi))
        self.i += 1
        if not ranges:
            raise GrammarError("empty char class")
        return ("char", tuple(ranges), neg)

    def _char(self) -> int:
        c = self.s[self.i]
        self.i += 1
        if c != "\\":
            return ord(c)
        e = self.s[self.i] if self.i < len(self.s) else ""
        self.i += 1
        simple = {"n": 10, "r": 13, "t": 9, '"': 34, "\\": 92, "/": 47,
                  "[": 91, "]": 93, "^": 94, "-": 45}
        if e in simple:
            return simple[e]
        width = {"x": 2, "u": 4, "U": 8}.get(e)
        if width:
            hexs = self.s[self.i:self.i + width]
            if len(hexs) != width:
                raise GrammarError(f"bad \\{e} escape")
            self.i += width
            try:
                return int(hexs, 16)
            except ValueError:  # the JAX parser lets this ValueError out
                raise GrammarError(f"bad \\{e} escape {hexs!r}") from None
        raise GrammarError(f"unknown escape \\{e}")


# --------------------------------------------------------------------------
# vocabulary masking: byte trie + UTF-8 partials + per-state mask cache


def _utf8_len(b0: int):
    if b0 < 0x80:
        return 1
    if 0xC0 <= b0 < 0xE0:
        return 2
    if 0xE0 <= b0 < 0xF0:
        return 3
    if 0xF0 <= b0 < 0xF8:
        return 4
    return None  # bare continuation byte / invalid leader


_MIN_CP = {1: 0, 2: 0x80, 3: 0x800, 4: 0x10000}  # minimal (non-overlong) cp


def _partial_cp_range(partial: bytes, n: int):
    """[lo, hi] of codepoints an incomplete UTF-8 sequence could decode to,
    clamped to the minimal-encoding floor so overlong leaders (0xC0/0xC1,
    0xE0+low bits, 0xF0+low bits) are infeasible unless a high completion
    exists. May be empty (lo > hi)."""
    v = partial[0] & (0x7F >> n)
    for c in partial[1:]:
        v = (v << 6) | (c & 0x3F)
    r = 6 * (n - len(partial))
    lo, hi = v << r, (v << r) | ((1 << r) - 1)
    return max(lo, _MIN_CP[n]), min(hi, 0x10FFFF)


def _feasible(el, lo: int, hi: int) -> bool:
    """Could any codepoint in [lo, hi] match this char element?"""
    _, ranges, neg = el
    if not neg:
        return any(rlo <= hi and lo <= rhi for rlo, rhi in ranges)
    covered = 0  # negated: feasible unless ranges cover all of [lo, hi]
    pos = lo     # cursor de-duplicates overlapping ranges
    for rlo, rhi in sorted(ranges):
        s, e = max(rlo, pos), min(rhi, hi)
        if s <= e:
            covered += e - s + 1
            pos = e + 1
    return covered < hi - lo + 1


class _Trie:
    __slots__ = ("children", "token_ids")

    def __init__(self):
        self.children: dict[int, _Trie] = {}
        self.token_ids: list[int] = []


def build_token_trie(pieces, eos_id: int):
    """Byte trie over token pieces (GrammarSampler's token-walk index).
    Depends only on the vocabulary — build once, share across samplers."""
    root = _Trie()
    for tid, piece in enumerate(pieces):
        piece = bytes(piece)
        if tid == eos_id or not piece:
            continue  # empty pieces / EOS handled by completion rule
        node = root
        for b in piece:
            node = node.children.setdefault(b, _Trie())
        node.token_ids.append(tid)
    return root


class GrammarSampler:
    """Per-generation grammar state over a token vocabulary.

    pieces: raw bytes per token id (Vocab.id_to_token). State = (parse
    stacks, partial UTF-8 tail); byte-level BPE tokens that end mid-
    codepoint keep the undecided bytes in `partial` until a later token
    completes them (rejected early if they cannot start a codepoint that
    any stack accepts is left to the codepoint check on completion — but a
    structurally invalid UTF-8 prefix is rejected immediately)."""

    def __init__(self, grammar: Grammar, pieces, eos_id: int, trie=None):
        self.grammar = grammar
        self.pieces = [bytes(p) for p in pieces]
        self.eos_id = eos_id
        # the byte trie depends only on (pieces, eos_id), not the grammar —
        # callers serving many requests over one vocab pass a shared trie
        # (build_token_trie) instead of rebuilding the 65k-piece tree per
        # request
        self._trie = trie if trie is not None \
            else build_token_trie(self.pieces, eos_id)
        self._mask_cache: dict = {}
        self._bits_cache: dict = {}
        self.reset()

    def reset(self):
        self.stacks = self.grammar.start()
        self.partial = b""

    # ------------------------------------------------------------ advance

    def _step_byte(self, stacks, partial: bytes, b: int):
        """Advance (stacks, partial) by one byte; None = dead end."""
        partial += bytes([b])
        n = _utf8_len(partial[0])
        if n is None:
            return None
        if len(partial) < n:
            if len(partial) > 1 and (partial[-1] & 0xC0) != 0x80:
                return None
            # incomplete codepoint: keep only stacks that could accept SOME
            # completion of these bytes (llama.cpp match_partial_char)
            lo, hi = _partial_cp_range(partial, n)
            kept = frozenset(
                s for s in stacks
                if s and _feasible(self.grammar.rules[s[-1][0]][s[-1][1]]
                                   [s[-1][2]], lo, hi))
            if not kept:
                return None
            return (kept, partial)
        if n > 1 and any((c & 0xC0) != 0x80 for c in partial[1:]):
            return None
        try:
            cp = ord(partial.decode("utf-8"))
        except UnicodeDecodeError:
            return None  # overlong / surrogate / out-of-range encoding
        stacks = self.grammar.advance(stacks, cp)
        if not stacks:
            return None
        return (stacks, b"")

    def _advance_state(self, stacks, partial: bytes, data: bytes):
        for b in data:
            nxt = self._step_byte(stacks, partial, b)
            if nxt is None:
                return None
            stacks, partial = nxt
        return (stacks, partial)

    # ------------------------------------------------------------ public

    def accept(self, token_id: int) -> None:
        """Commit a sampled token to the grammar state."""
        if token_id == self.eos_id:
            return
        nxt = self._advance_state(self.stacks, self.partial,
                                  self.pieces[token_id])
        if nxt is None:
            raise GrammarError(
                f"token {token_id} ({self.pieces[token_id]!r}) violates the "
                "grammar — was filter_logits applied?")
        self.stacks, self.partial = nxt

    def valid_token_ids(self) -> np.ndarray:
        """Ids of tokens whose bytes extend the current state (cached per
        state; computed by a pruned DFS over the shared-prefix byte trie)."""
        key = (self.stacks, self.partial)
        hit = self._mask_cache.get(key)
        if hit is not None:
            return hit
        out: list[int] = []
        work = [(self._trie, self.stacks, self.partial)]
        while work:
            node, stacks, partial = work.pop()
            out.extend(node.token_ids)
            for b, child in node.children.items():
                nxt = self._step_byte(stacks, partial, b)
                if nxt is not None:
                    work.append((child, nxt[0], nxt[1]))
        if not self.partial and Grammar.can_complete(self.stacks):
            out.append(self.eos_id)
        ids = np.asarray(sorted(out), dtype=np.int32)
        self._mask_cache[key] = ids
        return ids

    def valid_bits(self) -> np.ndarray:
        """Packed little-endian validity bits for the current state —
        np.packbits(valid_bool, bitorder='little'), cached per state. The
        upload format of the engine's fused masked decode (single-stream
        decode_chunk_masked and the batched per-row mask path)."""
        key = (self.stacks, self.partial)
        bits = self._bits_cache.get(key)
        if bits is None:
            ids = self.valid_token_ids()
            if not ids.size:
                raise GrammarError(
                    "no vocabulary token can extend the grammar from this "
                    f"state (partial UTF-8 tail {self.partial!r})")
            valid = np.zeros(len(self.pieces), bool)
            valid[ids] = True
            bits = np.packbits(valid, bitorder="little")
            self._bits_cache[key] = bits
        return bits

    def filter_logits(self, logits: np.ndarray) -> np.ndarray:
        """-inf-mask logits of grammar-invalid tokens (llama.cpp's
        llama_sample_grammar: applied BEFORE the sampler cascade)."""
        valid = self.valid_token_ids()
        if not valid.size:
            raise GrammarError(
                "no vocabulary token can extend the grammar from this state "
                f"(partial UTF-8 tail {self.partial!r})")
        out = np.full_like(logits, -np.inf)
        out[valid] = logits[valid]
        return out

