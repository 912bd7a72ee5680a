"""Write comet_tpu_torch/indexes/_uax29_table.py from the `regex` module.

    python3 scripts/gen_uax29_table.py

The port's UAX#29 word segmenter (comet_tpu_torch/indexes/uax29.py) runs on
the standard library alone. This script reads the Unicode database of the
`regex` module, which the JAX package's segmenter (comet_tpu/indexes/
uax29.py) queries with `\\p{...}` classes, and writes the codepoint ranges of
the 18 Word_Break classes it uses, of Extended_Pictographic and of
`[\\p{L}\\p{N}]`, with the module's version. Rerun it wherever `regex` is
installed after that module changes; `tests/test_torch_uax29.py` holds the
table to the installed database over every codepoint.
"""

from __future__ import annotations

import os
import sys

import regex

WB_CLASSES = [
    "CR", "LF", "Newline", "Extend", "ZWJ", "Regional_Indicator", "Format",
    "Katakana", "Hebrew_Letter", "ALetter", "Single_Quote", "Double_Quote",
    "MidNumLet", "MidLetter", "MidNum", "Numeric", "ExtendNumLet", "WSegSpace",
]
EXTRA = {
    "Extended_Pictographic": r"\p{Extended_Pictographic}",
    "LetterOrNumber": r"[\p{L}\p{N}]",
}
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "comet_tpu_torch", "indexes", "_uax29_table.py")


def ranges(pattern: str, text: str) -> list[tuple[int, int]]:
    """Inclusive (first, last) codepoint runs of `text` (every codepoint in
    order) that match the one-character `pattern`."""
    return [(m.start(), m.end() - 1) for m in regex.finditer(f"(?:{pattern})+", text)]


def table() -> dict[str, list[tuple[int, int]]]:
    everything = "".join(map(chr, range(sys.maxunicode + 1)))
    out = {name: ranges(rf"\p{{Word_Break={name}}}", everything) for name in WB_CLASSES}
    seen = set()
    for name in WB_CLASSES:   # the classes are disjoint by the standard
        cps = {c for a, b in out[name] for c in range(a, b + 1)}
        if cps & seen:
            raise SystemExit(f"Word_Break={name} overlaps an earlier class")
        seen |= cps
    out.update({name: ranges(p, everything) for name, p in EXTRA.items()})
    return out


def main() -> None:
    lines = [
        '"""Codepoint ranges for the UAX#29 word segmenter (indexes/uax29.py).',
        "",
        "Generated by scripts/gen_uax29_table.py from the Unicode database of",
        f"the `regex` module, version {regex.__version__}; do not edit by hand.",
        "Each entry maps a class to inclusive (first, last) codepoint runs: the",
        "Word_Break classes, Extended_Pictographic and LetterOrNumber",
        "(`[\\\\p{L}\\\\p{N}]`).",
        '"""',
        "",
        f'REGEX_VERSION = "{regex.__version__}"',
        "",
        "RANGES = {",
    ]
    for name, runs in table().items():
        lines.append(f'    "{name}": (')
        for i in range(0, len(runs), 6):
            lines.append("        " + " ".join(f"(0x{a:X}, 0x{b:X})," for a, b in runs[i:i + 6]))
        lines.append("    ),")
    lines.append("}")
    with open(OUT, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
