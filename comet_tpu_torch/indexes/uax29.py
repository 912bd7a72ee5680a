"""UAX#29 word segmentation (Unicode TR29 word-boundary rules).

Counterpart of comet_tpu/indexes/uax29.py, on the standard library alone:
the reference asks the `regex` module for `\\p{Word_Break=...}` classes,
which the port does not depend on. The codepoint ranges of those classes,
of Extended_Pictographic and of `[\\p{L}\\p{N}]` come from a vendored table
(`_uax29_table.py`, written by scripts/gen_uax29_table.py from the `regex`
module's database), so both packages segment every text alike.

``segment`` yields EVERY segment of the text — words, but also punctuation
and whitespace runs — as the Go reference's ``words.FromString`` does
(bm25_index.go:159-166). Two implementations, held to each other and to
the reference by tests/test_torch_uax29.py:

- ``segment_slow``: the rule-by-rule transcription of TR29's WB1-WB999.
- ``segment``: one compiled pattern (plain ASCII classes for ASCII text).
  The reference's pattern reads the folded left context of a Hebrew letter
  with a variable-width lookbehind, which the standard `re` refuses. Here
  the WB7b/c link (HL " HL) hangs on the Hebrew letter's own unit instead,
  and WB7a's terminal single quote after a word that ends in a Hebrew
  letter is joined to that word after the match (`_join_hebrew_quotes`).
"""

from __future__ import annotations

import bisect
import re

from comet_tpu_torch.indexes._uax29_table import RANGES

_WB_CLASSES = (
    "CR", "LF", "Newline", "Extend", "ZWJ", "Regional_Indicator", "Format",
    "Katakana", "Hebrew_Letter", "ALetter", "Single_Quote", "Double_Quote",
    "MidNumLet", "MidLetter", "MidNum", "Numeric", "ExtendNumLet", "WSegSpace",
)

# -- property lookup (slow path) -----------------------------------------------

_STARTS: list[int] = []
_ENDS: list[int] = []
_NAMES: list[str] = []
for _first, _last, _name in sorted(
    (a, b, name) for name in _WB_CLASSES for a, b in RANGES[name]
):
    _STARTS.append(_first)
    _ENDS.append(_last)
    _NAMES.append(_name)
_PICT = RANGES["Extended_Pictographic"]
_PICT_STARTS = [a for a, _ in _PICT]

_prop_cache: dict[str, str] = {}


def _wb_prop(ch: str) -> str:
    p = _prop_cache.get(ch)
    if p is None:
        cp = ord(ch)
        i = bisect.bisect_right(_STARTS, cp) - 1
        p = _NAMES[i] if i >= 0 and cp <= _ENDS[i] else "Other"
        _prop_cache[ch] = p
    return p


def _is_pict(ch: str) -> bool:
    cp = ord(ch)
    i = bisect.bisect_right(_PICT_STARTS, cp) - 1
    return i >= 0 and cp <= _PICT[i][1]


_AH = ("ALetter", "Hebrew_Letter")  # AHLetter
_MIDNUMLETQ = ("MidNumLet", "Single_Quote")
_EFZ = ("Extend", "Format", "ZWJ")
_NL = ("Newline", "CR", "LF")


def segment_slow(text: str) -> list[str]:
    """Reference implementation: evaluate WB1-WB999 at every position."""
    n = len(text)
    if n == 0:
        return []
    props = [_wb_prop(c) for c in text]
    ext_pict = [_is_pict(c) for c in text]

    def prev_base(i: int) -> int:
        """Largest j < i with a non-Extend/Format/ZWJ property, or -1."""
        j = i - 1
        while j >= 0 and props[j] in _EFZ:
            j -= 1
        return j

    def next_base(i: int) -> int:
        """Smallest j > i with a non-Extend/Format/ZWJ property, or n."""
        j = i + 1
        while j < n and props[j] in _EFZ:
            j += 1
        return j

    def is_boundary(i: int) -> bool:
        pl, pr = props[i - 1], props[i]
        # WB3: CR x LF
        if pl == "CR" and pr == "LF":
            return False
        # WB3a / WB3b: break around newlines
        if pl in _NL:
            return True
        if pr in _NL:
            return True
        # WB3c: ZWJ x Extended_Pictographic (literal chars)
        if text[i - 1] == "\u200d" and ext_pict[i]:
            return False
        # WB3d: WSegSpace x WSegSpace (literal adjacency)
        if pl == "WSegSpace" and pr == "WSegSpace":
            return False
        # WB4: X (Extend|Format|ZWJ)* -> X — never break before EFZ
        if pr in _EFZ:
            return False
        # fold the left context per WB4
        j1 = prev_base(i)
        if j1 < 0:
            return True  # only EFZ before us: WB999
        p1 = props[j1]
        j0 = prev_base(j1)
        p0 = props[j0] if j0 >= 0 else None
        k = next_base(i)
        r2 = props[k] if k < n else None

        if p1 in _AH and pr in _AH:  # WB5
            return False
        if p1 in _AH and (pr == "MidLetter" or pr in _MIDNUMLETQ) and r2 in _AH:  # WB6
            return False
        if (p0 in _AH) and (p1 == "MidLetter" or p1 in _MIDNUMLETQ) and pr in _AH:  # WB7
            return False
        if p1 == "Hebrew_Letter" and pr == "Single_Quote":  # WB7a
            return False
        if p1 == "Hebrew_Letter" and pr == "Double_Quote" and r2 == "Hebrew_Letter":  # WB7b
            return False
        if p0 == "Hebrew_Letter" and p1 == "Double_Quote" and pr == "Hebrew_Letter":  # WB7c
            return False
        if p1 == "Numeric" and pr == "Numeric":  # WB8
            return False
        if p1 in _AH and pr == "Numeric":  # WB9
            return False
        if p1 == "Numeric" and pr in _AH:  # WB10
            return False
        if p0 == "Numeric" and (p1 == "MidNum" or p1 in _MIDNUMLETQ) and pr == "Numeric":  # WB11
            return False
        if p1 == "Numeric" and (pr == "MidNum" or pr in _MIDNUMLETQ) and r2 == "Numeric":  # WB12
            return False
        if p1 == "Katakana" and pr == "Katakana":  # WB13
            return False
        if p1 in ("ALetter", "Hebrew_Letter", "Numeric", "Katakana", "ExtendNumLet") and pr == "ExtendNumLet":  # WB13a
            return False
        if p1 == "ExtendNumLet" and pr in ("ALetter", "Hebrew_Letter", "Numeric", "Katakana"):  # WB13b
            return False
        if p1 == "Regional_Indicator" and pr == "Regional_Indicator":  # WB15/16
            # join only if the number of preceding consecutive RIs is odd
            count = 0
            j = j1
            while j >= 0 and props[j] == "Regional_Indicator":
                count += 1
                j = prev_base(j)
            if count % 2 == 1:
                return False
        return True  # WB999

    out: list[str] = []
    start = 0
    for i in range(1, n):
        if is_boundary(i):
            out.append(text[start:i])
            start = i
    out.append(text[start:])
    return out


# -- fast path: the same grammar as one compiled pattern -------------------------


def _cls(*names: str) -> str:
    """A character class of the union of the named tables' ranges."""
    parts = []
    for name in names:
        for a, b in RANGES[name]:
            parts.append(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}")
    return "[" + "".join(parts) + "]"


def _build_pattern() -> re.Pattern:
    CR = r"\r"
    LF = r"\n"
    NLCLS = "[\\r\\n\\x0b\\x0c\\x85\\u2028\\u2029]"
    EFZ = _cls("Extend", "Format", "ZWJ")
    # WB4 absorption after every char
    E = rf"{EFZ}*+"
    # WB3c: a literal trailing ZWJ pulls in a following Extended_Pictographic
    # (which may itself chain ZWJ+ExtPict). The pictograph folds as Other, so
    # no word rule can continue past it — the absorption is TERMINAL and is
    # appended once at the end of each token alternative.
    T = rf"(?:(?<=\u200d){_cls('Extended_Pictographic')}{EFZ}*+)*+"
    WS = _cls("WSegSpace")
    ALO = _cls("ALetter")
    HL = _cls("Hebrew_Letter")
    AL = _cls("ALetter", "Hebrew_Letter")
    NU = _cls("Numeric")
    KA = _cls("Katakana")
    EXNL = _cls("ExtendNumLet")
    LMID = _cls("MidLetter", "MidNumLet", "Single_Quote")
    NMID = _cls("MidNum", "MidNumLet", "Single_Quote")
    DQ = _cls("Double_Quote")
    RI = _cls("Regional_Indicator")

    # a letter unit; a Hebrew letter's unit carries the WB7b/c link
    # (HL " HL), which the reference writes as a lookbehind on its link
    Lx = rf"(?:{ALO}{E}|{HL}{E}(?:{DQ}{E}(?={HL}))?)"
    Lrun = rf"{Lx}(?:(?:{LMID}{E})?{Lx})*"
    Nx = rf"{NU}{E}"
    Nrun = rf"{Nx}(?:(?:{NMID}{E})?{Nx})*"
    LN = rf"(?:{Lrun}|{Nrun})+"  # WB9/WB10: letters and digits adjoin freely
    KArun = rf"(?:{KA}{E})+"
    EXrun = rf"(?:{EXNL}{E})+"
    Block = rf"(?:{LN}|{KArun})"
    Word = rf"(?:(?:{EXrun})?{Block}(?:{EXrun}{Block})*(?:{EXrun})?|{EXrun})"
    RIpair = rf"{RI}{E}{RI}{E}|{RI}{E}"
    Any = rf".{E}"

    return re.compile(
        rf"{CR}{LF}|{NLCLS}|(?:{WS}+{E}|{Word}|{RIpair}|{Any}){T}",
        re.DOTALL,
    )


_PATTERN = _build_pattern()
_HEBREW = re.compile(_cls("Hebrew_Letter"))
_SINGLE_QUOTE = re.compile(_cls("Single_Quote"))


def _join_hebrew_quotes(tokens: list[str]) -> list[str]:
    """WB7a: a single quote right after a word whose last base character is
    a Hebrew letter ends that word. The reference's pattern takes it as the
    word's terminal part; the pattern here leaves it a token of its own
    (`'` and what WB4 absorbs after it), which this joins back."""
    out: list[str] = []
    for tok in tokens:
        if out and _wb_prop(tok[0]) == "Single_Quote":
            prev = out[-1]
            j = len(prev) - 1
            while j >= 0 and _wb_prop(prev[j]) in _EFZ:
                j -= 1
            if j >= 0 and _wb_prop(prev[j]) == "Hebrew_Letter":
                out[-1] = prev + tok
                continue
        out.append(tok)
    return out


def _build_ascii_pattern() -> re.Pattern:
    """The same grammar restricted to ASCII (no Extend/Format/ZWJ, no
    Hebrew/Katakana/Regional_Indicator exist below U+0080), from plain
    character classes. ASCII WB classes: ALetter=[A-Za-z] Numeric=[0-9]
    ExtendNumLet=[_] MidLetter=[:] MidNumLet=[.] MidNum=[,;]
    Single_Quote=['] WSegSpace=[ ] Newline=[\\x0b\\x0c] CR LF; everything
    else Other."""
    Lrun = r"[A-Za-z]+(?:[:.'][A-Za-z]+)*"
    Nrun = r"[0-9]+(?:[.,;'][0-9]+)*"
    LN = rf"(?:{Lrun}|{Nrun})+"
    Word = rf"(?:_*{LN}(?:_+{LN})*_*|_+)"
    return re.compile(rf"\r\n|[\r\n\x0b\x0c]| +|{Word}|.", re.DOTALL)


_ASCII_PATTERN = _build_ascii_pattern()


def segment(text: str) -> list[str]:
    """Partition ``text`` into UAX#29 word segments (all of them, including
    whitespace and punctuation — ``words.FromString`` semantics)."""
    if not text:
        return []
    if text.isascii():
        return _ASCII_PATTERN.findall(text)
    tokens = _PATTERN.findall(text)
    if _HEBREW.search(text) and _SINGLE_QUOTE.search(text):
        tokens = _join_hebrew_quotes(tokens)
    return tokens


_WORDLIKE = re.compile(_cls("LetterOrNumber"))


def wordlike(tokens: list[str]) -> list[str]:
    """Optional filter: keep only segments containing a letter or digit
    (NOT what the reference does — it indexes every segment)."""
    return [t for t in tokens if _WORDLIKE.search(t)]
