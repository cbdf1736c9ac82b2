"""Device regex subset engine: a literal pattern compiles on the host to
an epsilon-free Thompson NFA whose active-state sets travel as 64-bit
BITMASKS advanced over the padded byte matrix, one vectorized step per
byte column.

Ported from ``spark_rapids_tpu/expr/device_regex.py``.  The parser, the
NFA builder, ``compile_pattern`` and ``CompiledRegex`` (:44-475) are
copied; ``_step_masks``, ``rlike`` and ``match_ends`` are written in torch.
The reference's uint64 state masks are held in int64: bit 63 is the sign
bit, so ``1 << 63`` is INT64_MIN, and ``(active >> s) & 1`` stays correct
under torch's arithmetic shift.  Each ``lax.scan`` over byte columns is a
Python loop.  With at most 64 NFA states, "which states are alive" is one
int64 per (row [, start position]) lane.

Supported subset (everything else raises ``Unsupported`` so the planner
falls back to the CPU with a tagged reason):
  - literal ASCII bytes, ``.`` (any byte except newline, like Java)
  - character classes ``[a-z0-9_]``, negated ``[^...]``, ranges,
    and the escapes ``\\d \\D \\w \\W \\s \\S`` inside or outside classes
  - escaped metacharacters ``\\. \\\\ \\+ ...``, ``\\n \\t \\r \\f \\a \\e``
  - anchors ``^`` (pattern start only) and ``$`` (pattern end only)
  - greedy quantifiers ``? * + {m} {m,} {m,n}`` (lazy ``*?`` etc. are
    not; bounded repeats expand by fragment copying)
  - grouping ``(...)`` / ``(?:...)`` and alternation ``|``

Not supported: backreferences, lookaround, inline flags, named groups,
non-ASCII pattern characters, patterns needing more than 64 NFA states.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.expr.eval_tpu import longest

MAX_STATES = 64          # active set must fit one uint64 lane
_NL = ord("\n")


class Unsupported(Exception):
    """Pattern outside the device subset — caller falls back to CPU."""


# ---------------------------------------------------------------------------
# parse: pattern -> AST
# ---------------------------------------------------------------------------
# AST nodes (tuples):
#   ("cls", frozenset_of_bytes)      one byte from the set
#   ("cat", [nodes])                 concatenation
#   ("alt", [nodes])                 alternation
#   ("rep", node, lo, hi)            hi=None means unbounded

_DIGITS = frozenset(range(ord("0"), ord("9") + 1))
_WORD = frozenset(
    list(range(ord("a"), ord("z") + 1)) +
    list(range(ord("A"), ord("Z") + 1)) +
    list(range(ord("0"), ord("9") + 1)) + [ord("_")])
_SPACE = frozenset(b" \t\n\r\f\v")
_ALL = frozenset(range(256))
_DOT = _ALL - {_NL}

_ESC_CLS = {"d": _DIGITS, "D": _ALL - _DIGITS, "w": _WORD,
            "W": _ALL - _WORD, "s": _SPACE, "S": _ALL - _SPACE}
_ESC_LIT = {"n": _NL, "t": ord("\t"), "r": ord("\r"), "f": ord("\f"),
            "a": ord("\a"), "e": 0x1B, "0": 0}


class _Parser:
    def __init__(self, pat: str):
        if any(ord(ch) > 127 for ch in pat):
            raise Unsupported("non-ASCII pattern")
        self.p = pat
        self.i = 0
        self.anchor_start = False
        self.anchor_end = False

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self):
        if self.peek() == "^":
            self.anchor_start = True
            self.take()
        node = self.alt(top=True)
        if self.i != len(self.p):
            raise Unsupported(f"unexpected '{self.p[self.i]}' at "
                              f"{self.i}")
        if (self.anchor_start or self.anchor_end) and node[0] == "alt":
            # '^a|b' anchors only the FIRST branch in Java ('$' only the
            # last); flag-style anchors would wrongly anchor every
            # branch — group it as '^(a|b)' to anchor the whole pattern
            raise Unsupported("anchor with top-level alternation")
        return node

    def alt(self, top: bool = False):
        branches = [self.cat(top)]
        while self.peek() == "|":
            self.take()
            branches.append(self.cat(top))
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def cat(self, top: bool):
        parts = []
        while True:
            ch = self.peek()
            if ch is None or ch == "|" or ch == ")":
                break
            if ch == "$":
                # only valid as the very last pattern character
                if top and self.i == len(self.p) - 1:
                    self.anchor_end = True
                    self.take()
                    break
                raise Unsupported("'$' not at pattern end")
            if ch == "^":
                raise Unsupported("'^' not at pattern start")
            parts.append(self.quantified())
        return ("cat", parts)

    def quantified(self):
        node = self.atom()
        ch = self.peek()
        lo = hi = None
        if ch == "?":
            self.take()
            lo, hi = 0, 1
        elif ch == "*":
            self.take()
            lo, hi = 0, None
        elif ch == "+":
            self.take()
            lo, hi = 1, None
        elif ch == "{":
            save = self.i
            self.take()
            digits = ""
            while self.peek() is not None and self.peek().isdigit():
                digits += self.take()
            if not digits:
                self.i = save          # '{' literal, like Java
                return node
            m = int(digits)
            if self.peek() == "}":
                self.take()
                lo, hi = m, m
            elif self.peek() == ",":
                self.take()
                digits2 = ""
                while self.peek() is not None and self.peek().isdigit():
                    digits2 += self.take()
                if self.peek() != "}":
                    self.i = save
                    return node
                self.take()
                lo, hi = m, (int(digits2) if digits2 else None)
            else:
                self.i = save
                return node
            if hi is not None and hi < lo:
                raise Unsupported("{m,n} with n < m")
            if (hi or lo) > 32:
                raise Unsupported("bounded repeat > 32")
        if lo is None:
            return node
        if self.peek() in ("?", "+"):
            raise Unsupported("lazy/possessive quantifiers")
        return ("rep", node, lo, hi)

    def atom(self):
        ch = self.take()
        if ch == "(":
            if self.peek() == "?":
                self.take()
                if self.peek() != ":":
                    raise Unsupported("only (?:...) groups")
                self.take()
            node = self.alt()
            if self.peek() != ")":
                raise Unsupported("unbalanced group")
            self.take()
            return node
        if ch == "[":
            return ("cls", self.char_class())
        if ch == ".":
            return ("cls", _DOT)
        if ch == "\\":
            return ("cls", self.escape(in_class=False))
        if ch in "*+?)":
            raise Unsupported(f"dangling '{ch}'")
        return ("cls", frozenset({ord(ch)}))

    def escape(self, in_class: bool) -> frozenset:
        if self.peek() is None:
            raise Unsupported("trailing backslash")
        ch = self.take()
        if ch in _ESC_CLS:
            return _ESC_CLS[ch]
        if ch in _ESC_LIT:
            return frozenset({_ESC_LIT[ch]})
        if not ch.isalnum():
            return frozenset({ord(ch)})
        raise Unsupported(f"escape \\{ch}")

    def char_class(self) -> frozenset:
        negate = False
        if self.peek() == "^":
            negate = True
            self.take()
        members: set = set()
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                raise Unsupported("unterminated class")
            if ch == "]" and not first:
                self.take()
                break
            first = False
            if ch == "\\":
                self.take()
                members |= self.escape(in_class=True)
                if self.peek() == "-" and self.i + 1 < len(self.p) \
                        and self.p[self.i + 1] != "]":
                    raise Unsupported("class escape as range bound")
                continue
            lo = ord(self.take())
            if self.peek() == "-" and self.i + 1 < len(self.p) and \
                    self.p[self.i + 1] != "]":
                self.take()
                nxt = self.peek()
                if nxt == "\\":
                    raise Unsupported("escape as range bound")
                hi = ord(self.take())
                if hi < lo:
                    raise Unsupported("reversed class range")
                members |= set(range(lo, hi + 1))
            else:
                members.add(lo)
        if not members:
            raise Unsupported("empty class")
        return frozenset(_ALL - members) if negate else frozenset(members)


# ---------------------------------------------------------------------------
# compile: AST -> epsilon-free NFA with bitmask states
# ---------------------------------------------------------------------------

@dataclass
class CompiledRegex:
    pattern: str
    classes: np.ndarray           # [C, 256] bool lookup tables
    transitions: List[Tuple[int, int, int]]   # (src_state, cls, tgt)
    start_mask: int               # closure of the start state
    accept_mask: int
    anchor_start: bool
    anchor_end: bool
    min_len: int                  # shortest possible match, 0 if empty ok
    has_alt: bool                 # pattern contains alternation
    n_variable: int               # variable-length elements (see below)
    n_states: int

    @property
    def replace_safe(self) -> bool:
        """True when the LONGEST match per start (what match_ends
        computes) provably equals Java's greedy-backtracking match for
        every input: no alternation, at most ONE variable-length
        element, and at least one consumed byte.  With a single
        variable element all matches at a start differ only in its
        repeat count, so greedy-max == longest; with two (e.g.
        a{1,2}(ab)? on 'aab') Java's earlier-greedy choice can force a
        SHORTER overall match than the longest."""
        return (not self.has_alt and self.min_len >= 1
                and self.n_variable <= 1)


class _NfaBuilder:
    """Glushkov-style position automaton: one state per character-class
    occurrence (plus state 0 = start), which is epsilon-free by
    construction and linear in pattern size."""

    def __init__(self):
        self.classes: List[frozenset] = []
        self._cls_ids: Dict[frozenset, int] = {}
        self.state_cls: List[int] = []     # class consumed ENTERING state
        self.follow: List[Tuple[int, set]] = []   # (state, next-states)

    def cls_id(self, s: frozenset) -> int:
        if s not in self._cls_ids:
            self._cls_ids[s] = len(self.classes)
            self.classes.append(s)
        return self._cls_ids[s]

    def new_state(self, cls: int) -> int:
        sid = len(self.state_cls) + 1      # state 0 is reserved start
        if sid >= MAX_STATES:
            raise Unsupported(f"pattern needs > {MAX_STATES - 1} states")
        self.state_cls.append(cls)
        return sid

    # each build returns (first, last, nullable):
    #   first: set of states that can consume the fragment's 1st byte
    #   last:  set of states a completed fragment can end in
    #   nullable: fragment can match empty
    def build(self, node):
        kind = node[0]
        if kind == "cls":
            sid = self.new_state(self.cls_id(node[1]))
            return {sid}, {sid}, False
        if kind == "cat":
            first: set = set()
            last: set = set()
            nullable = True
            for child in node[1]:
                f, l, nu = self.build(child)
                # link: every last-so-far flows into child's first
                self.follow.extend((p, f) for p in last)
                if nullable:
                    first |= f
                if nu:
                    last |= l
                else:
                    last = set(l)
                nullable = nullable and nu
            return first, last, nullable
        if kind == "alt":
            first, last = set(), set()
            nullable = False
            for child in node[1]:
                f, l, nu = self.build(child)
                first |= f
                last |= l
                nullable = nullable or nu
            return first, last, nullable
        if kind == "rep":
            _, child, lo, hi = node
            # expand to lo required copies + optional tail
            first, last, nullable = set(), set(), True
            copies: List[Tuple[set, set, bool]] = []
            n_req = lo if lo > 0 else 0
            if hi is None:
                n_copies = max(n_req, 1)
            else:
                n_copies = hi
            if n_copies == 0:          # {0,0}
                return set(), set(), True
            for k in range(n_copies):
                f, l, nu = self.build(child)
                copies.append((f, l, nu))
            # link consecutive copies
            for k in range(n_copies - 1):
                for p in copies[k][1]:
                    self.follow.append((p, copies[k + 1][0]))
            if hi is None:
                # last copy loops to itself
                f, l, _nu = copies[-1]
                for p in l:
                    self.follow.append((p, f))
            # firsts: copy k's first reachable if copies 0..k-1 nullable
            reach_nullable = True
            for k in range(n_copies):
                if reach_nullable:
                    first |= copies[k][0]
                reach_nullable = reach_nullable and copies[k][2]
            # lasts: copy k's last is a fragment end if k >= lo-1 OR
            # all copies after k are optional (k >= lo-1 covers both
            # since copies beyond lo are the optional tail)
            for k in range(n_copies):
                if k >= lo - 1:
                    last |= copies[k][1]
            frag_nullable = (lo == 0) or all(c[2] for c in copies[:lo])
            return first, last, frag_nullable
        raise AssertionError(kind)


def _min_len(node) -> int:
    kind = node[0]
    if kind == "cls":
        return 1
    if kind == "cat":
        return sum(_min_len(c) for c in node[1])
    if kind == "alt":
        return min(_min_len(c) for c in node[1])
    if kind == "rep":
        return node[2] * _min_len(node[1])
    raise AssertionError(kind)


def _n_variable(node) -> int:
    """Count variable-length elements, conservatively: a rep with
    lo != hi (or unbounded) is one, plus double-weight for any variable
    content it repeats; a fixed rep multiplies its child's count by the
    copies made."""
    kind = node[0]
    if kind == "cls":
        return 0
    if kind == "cat":
        return sum(_n_variable(c) for c in node[1])
    if kind == "alt":
        return max((_n_variable(c) for c in node[1]), default=0)
    if kind == "rep":
        _, child, lo, hi = node
        inner = _n_variable(child)
        if hi is not None and hi == lo:
            return min(lo, 2) * inner
        return 1 + 2 * inner
    raise AssertionError(kind)


def _has_alt(node) -> bool:
    kind = node[0]
    if kind == "cls":
        return False
    if kind == "alt":
        return True
    if kind == "cat":
        return any(_has_alt(c) for c in node[1])
    if kind == "rep":
        return _has_alt(node[1])
    raise AssertionError(kind)


def compile_pattern(pattern: str) -> CompiledRegex:
    """Parse+compile; raises Unsupported outside the subset."""
    if not pattern:
        raise Unsupported("empty pattern")
    parser = _Parser(pattern)
    ast = parser.parse()
    b = _NfaBuilder()
    first, last, nullable = b.build(ast)

    n_states = len(b.state_cls) + 1
    transitions: List[Tuple[int, int, int]] = []
    # start (state 0) -> first positions
    for tgt in sorted(first):
        transitions.append((0, b.state_cls[tgt - 1], tgt))
    # follow links: src state -> targets (consuming target's class)
    seen = set()
    for src, tgts in b.follow:
        for tgt in sorted(tgts):
            key = (src, tgt)
            if key in seen:
                continue
            seen.add(key)
            transitions.append((src, b.state_cls[tgt - 1], tgt))

    accept_mask = 0
    for s in last:
        accept_mask |= 1 << s
    if nullable:
        accept_mask |= 1       # start state accepts (empty match)

    cls_arr = np.zeros((len(b.classes), 256), dtype=bool)
    for i, s in enumerate(b.classes):
        cls_arr[i, list(s)] = True

    return CompiledRegex(
        pattern=pattern, classes=cls_arr, transitions=transitions,
        start_mask=1, accept_mask=accept_mask,
        anchor_start=parser.anchor_start, anchor_end=parser.anchor_end,
        min_len=_min_len(ast), has_alt=_has_alt(ast),
        n_variable=_n_variable(ast), n_states=n_states)


# ---------------------------------------------------------------------------
# device evaluation
# ---------------------------------------------------------------------------

def _i64(mask: int) -> int:
    """A uint64 mask as the int64 with the same bits."""
    return mask - (1 << 64) if mask >= (1 << 63) else mask


def _edges(cr: CompiledRegex):
    """The transitions grouped by (source state, class): one target mask
    per group, so a step costs one select per group."""
    groups: Dict[Tuple[int, int], int] = {}
    for src, cls, tgt in cr.transitions:
        groups[(src, cls)] = groups.get((src, cls), 0) | (1 << tgt)
    return [(src, cls, _i64(m)) for (src, cls), m in sorted(groups.items())]


def _step_masks(edges, active: torch.Tensor,
                cls_byte: torch.Tensor) -> torch.Tensor:
    """One NFA step: advance int64 active-state masks by one byte.
    ``cls_byte`` is ``[..., C]`` bool (does this lane's byte match class
    c); ``active`` is int64 of the same leading shape."""
    nxt = torch.zeros_like(active)
    alive = {}
    for src, cls, tgts in edges:
        if src not in alive:
            alive[src] = ((active >> src) & 1) != 0
        fire = alive[src] & cls_byte[..., cls]
        nxt = nxt | torch.where(fire, tgts, 0)
    return nxt


def _class_table(cr: CompiledRegex, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(cr.classes.T)).to(
        like.device)                                   # [256, C] bool


def rlike(cr: CompiledRegex, data: torch.Tensor,
          lengths: torch.Tensor) -> torch.Tensor:
    """Java Matcher.find() semantics: does any substring match?
    [n] bool over the padded byte matrix."""
    n, w = data.shape
    dev = data.device
    cls_tab = _class_table(cr, data)
    edges = _edges(cr)
    start = _i64(cr.start_mask)
    accept = _i64(cr.accept_mask)
    active = torch.zeros((n,), dtype=torch.int64, device=dev)
    hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    # past the longest row no lane is alive and no row can accept: the
    # steps there change nothing (the last one that can is at its length)
    for j in range(min(w, longest(lengths) + 1)):
        if cr.anchor_start and j > 0:
            act = active
        else:
            act = active | torch.where(j <= lengths, start, 0)
        ok = (act & accept) != 0
        if cr.anchor_end:
            ok = ok & (j == lengths)
        hit = hit | ok
        cls_byte = cls_tab[data[:, j].to(torch.int64)] & \
            (j < lengths)[:, None]
        active = _step_masks(edges, act, cls_byte)
    # final step at j == w: empty-match injection and the accept check
    can_start = lengths == w
    if cr.anchor_start and w != 0:
        can_start = torch.zeros_like(can_start)
    act = active | torch.where(can_start, start, 0)
    ok = (act & accept) != 0
    if cr.anchor_end:
        ok = ok & (lengths == w)
    return hit | ok


def match_ends(cr: CompiledRegex, data: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """Longest-match table: E[r, p] = exclusive end of the LONGEST match
    of the pattern starting at byte p of row r, or -1.  Requires
    ``cr.min_len >= 1`` (no empty matches); callers gate on it.

    One int64 active-mask lane per (row, start position): step j advances
    every start hypothesis at once.  Only starts 0..j can be alive at
    step j (start p is injected at step p), so the step works on those
    columns alone; the others stay zero, as in the reference's full-width
    step.  The steps stop at the longest row."""
    assert cr.min_len >= 1, "empty-matchable pattern"
    n, w = data.shape
    dev = data.device
    cls_tab = _class_table(cr, data)
    edges = _edges(cr)
    start = _i64(cr.start_mask)
    accept = _i64(cr.accept_mask)
    active = torch.zeros((n, w), dtype=torch.int64, device=dev)
    ends = torch.full((n, w), -1, dtype=torch.int32, device=dev)
    # a match ends inside its row: past the longest row nothing is alive
    for j in range(min(w, longest(lengths))):
        lanes = 1 if cr.anchor_start else j + 1
        act = active[:, :lanes]
        if not cr.anchor_start:
            act[:, j] |= start
        elif j == 0:
            act[:, 0] |= start
        cls_byte = (cls_tab[data[:, j].to(torch.int64)] &
                    (j < lengths)[:, None])[:, None, :]
        nxt = _step_masks(edges, act, cls_byte)
        acc = (nxt & accept) != 0
        if cr.anchor_end:
            acc = acc & ((j + 1) == lengths)[:, None]
        ends[:, :lanes] = torch.where(acc, j + 1, ends[:, :lanes])
        active[:, :lanes] = nxt
    return ends
