"""CMUdict (ARPAbet) dictionary wrapper, copied from
`unast_tpu/text/cmudict.py` — parity with reference
src/data/cmudict.py:20-66. Present-but-unused on the reference's main path
(its phonemizer uses eng_to_ipa; SURVEY.md §2.1 #4); kept for API parity and
for users supplying their own cmudict file to extend the G2P lexicon.
"""

import re
from typing import Dict, List, Optional

VALID_SYMBOLS = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2", "AH", "AH0",
    "AH1", "AH2", "AO", "AO0", "AO1", "AO2", "AW", "AW0", "AW1", "AW2",
    "AY", "AY0", "AY1", "AY2", "B", "CH", "D", "DH", "EH", "EH0", "EH1",
    "EH2", "ER", "ER0", "ER1", "ER2", "EY", "EY0", "EY1", "EY2", "F", "G",
    "HH", "IH", "IH0", "IH1", "IH2", "IY", "IY0", "IY1", "IY2", "JH", "K",
    "L", "M", "N", "NG", "OW", "OW0", "OW1", "OW2", "OY", "OY0", "OY1",
    "OY2", "P", "R", "S", "SH", "T", "TH", "UH", "UH0", "UH1", "UH2", "UW",
    "UW0", "UW1", "UW2", "V", "W", "Y", "Z", "ZH",
]
_valid_symbol_set = set(VALID_SYMBOLS)

_alt_re = re.compile(r"\([0-9]+\)")


def _parse_entry(parts: List[str]) -> Optional[str]:
    for part in parts:
        if part not in _valid_symbol_set:
            return None
    return " ".join(parts)


class CMUDict:
    """unast_tpu/text/cmudict.py::CMUDict: a thin wrapper around a
    cmudict-format pronunciation file."""

    def __init__(self, file_or_path, keep_ambiguous: bool = True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding="latin-1") as f:
                entries = _parse_cmudict(f)
        else:
            entries = _parse_cmudict(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self):
        return len(self._entries)

    def lookup(self, word: str) -> Optional[List[str]]:
        """ARPAbet pronunciation(s) of `word`, or None."""
        return self._entries.get(word.upper())


def _parse_cmudict(file) -> Dict[str, List[str]]:
    """unast_tpu/text/cmudict.py::_parse_cmudict."""
    cmudict: Dict[str, List[str]] = {}
    for line in file:
        if len(line) and (line[0] >= "A" and line[0] <= "Z" or line[0] == "'"):
            parts = line.split("  ")
            word = _alt_re.sub("", parts[0])
            pron = _parse_entry(parts[1].strip().split(" "))
            if pron is not None:
                cmudict.setdefault(word, []).append(pron)
    return cmudict
