"""The port's UAX#29 segmenter against the reference's.

comet_tpu_torch/indexes/uax29.py runs on the standard library and a
vendored codepoint table; comet_tpu/indexes/uax29.py on the `regex`
module. The table is held to the `regex` database over every codepoint,
and both of the port's segmenters (the compiled pattern and the rule
machine) to both of the reference's on its curated strings and on seeded
strings drawn from every Word_Break class.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import regex

from comet_tpu.indexes import uax29 as ref
from comet_tpu_torch.indexes import _uax29_table, uax29

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CURATED = [
    "Hello, world!", "the quick-brown fox!", "don't stop", "can't won't o'clock",
    "example.com", "user@host.org", "a:b a.b a..b", "1,000.50", "3.14 v2.0", "1a.2",
    "__init__", "foo_bar 1_000", "カタカナ", "漢字", "ひらがな", 'אבג"דה', "אב'",
    "👩‍👩‍👧‍👦", "🇺🇸🇫🇷🇩", "a\r\nb\nc", "  two  spaces  ", "abc123def",
    "", "café 123 a_b", "Der schnelle braune Fuchs überspringt", "ג'0", 'א"ב"ג', "א'ב",
    "א́'", "א‍'x", "א'.b", "a'́b", "x‍👍́'",
]


def _class_chars(rng, per_class=3):
    """A few codepoints of every Word_Break class of the table, and of no
    class (Other)."""
    chars = []
    for name in uax29._WB_CLASSES:
        runs = _uax29_table.RANGES[name]
        for r in rng.integers(0, len(runs), size=per_class):
            a, b = runs[r]
            chars.append(chr(int(rng.integers(a, b + 1))))
    chars += list("漢字ひ😀👍🐶!?-@#")
    return chars


def _seeded_strings(seed, count, max_len):
    rng = np.random.default_rng(seed)
    alphabet = _class_chars(rng) + list("אבגדה'\"‍ ́­.,_:1a")
    out = []
    for _ in range(count):
        n = int(rng.integers(0, max_len + 1))
        out.append("".join(alphabet[i] for i in rng.integers(0, len(alphabet), size=n)))
    return out


def test_table_equals_the_regex_database_over_every_codepoint():
    everything = "".join(map(chr, range(sys.maxunicode + 1)))
    patterns = {name: rf"\p{{Word_Break={name}}}" for name in uax29._WB_CLASSES}
    patterns["Extended_Pictographic"] = r"\p{Extended_Pictographic}"
    patterns["LetterOrNumber"] = r"[\p{L}\p{N}]"
    assert set(_uax29_table.RANGES) == set(patterns)
    for name, pattern in patterns.items():
        want = np.array([m.start() for m in regex.finditer(pattern, everything)])
        got = np.concatenate([np.arange(a, b + 1) for a, b in _uax29_table.RANGES[name]])
        assert np.array_equal(np.sort(got), want), name


def test_module_imports_without_regex():
    code = (
        "import sys\n"
        "sys.modules['regex'] = None\n"
        "from comet_tpu_torch.indexes import uax29\n"
        "assert uax29.segment('a b') == ['a', ' ', 'b']\n"
        "from comet_tpu_torch.indexes.bm25 import BM25SearchIndex\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize("text", CURATED)
def test_curated_strings_match_reference(text):
    want = ref.segment(text)
    assert ref.segment_slow(text) == want
    assert uax29.segment(text) == want
    assert uax29.segment_slow(text) == want
    assert uax29.wordlike(want) == ref.wordlike(want)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_strings_from_every_class_match_reference(seed):
    for text in _seeded_strings(seed, 300, 24):
        want = ref.segment(text)
        assert uax29.segment(text) == want, repr(text)
        assert uax29.segment_slow(text) == ref.segment_slow(text), repr(text)
        assert uax29.wordlike(want) == ref.wordlike(want), repr(text)


def test_seeded_hebrew_quote_strings_match_reference():
    rng = np.random.default_rng(11)
    alphabet = list("אבג'\"a1_.́‍ ")
    for _ in range(1500):
        n = int(rng.integers(1, 12))
        text = "".join(alphabet[i] for i in rng.integers(0, len(alphabet), size=n))
        want = ref.segment(text)
        assert uax29.segment(text) == want, repr(text)
        assert uax29.segment_slow(text) == ref.segment_slow(text), repr(text)


def test_ascii_printable_matches_reference():
    rng = np.random.default_rng(5)
    printable = [chr(c) for c in range(32, 127)] + ["\r", "\n", "\t", "\x0b", "\x0c"]
    for _ in range(300):
        n = int(rng.integers(0, 80))
        text = "".join(printable[i] for i in rng.integers(0, len(printable), size=n))
        assert uax29.segment(text) == ref.segment(text), repr(text)
        assert uax29.segment(text) == uax29._PATTERN.findall(text), repr(text)
