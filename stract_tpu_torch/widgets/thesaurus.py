"""Thesaurus widget (the port's copy of stract_tpu/widgets/thesaurus.py;
role of reference widgets/thesaurus.rs — WordNet TTL based
"define <word>" lookups).

Loads a WordNet-subset TSV (`lemma\tpos\tdefinition\tsynonym1,synonym2`) when
provided (the reference downloads a wordnet subset in `configure`); ships a
small built-in sample so the widget works out of the box."""

from __future__ import annotations

import os
from collections import defaultdict
from dataclasses import dataclass, field

_BUILTIN = [
    ("happy", "adj", "enjoying or showing or marked by joy or pleasure", ["felicitous", "glad", "joyful"]),
    ("fast", "adj", "acting or moving or capable of acting or moving quickly", ["quick", "rapid", "speedy"]),
    ("fast", "adv", "quickly or rapidly", ["quickly", "rapidly"]),
    ("search", "verb", "try to locate or discover", ["seek", "look for", "hunt"]),
    ("search", "noun", "the activity of looking thoroughly", ["hunt", "lookup"]),
    ("big", "adj", "above average in size or number or quantity", ["large", "great", "sizable"]),
    ("small", "adj", "limited or below average in number or quantity", ["little", "minor", "modest"]),
]


@dataclass
class Meaning:
    pos: str
    definition: str
    synonyms: list = field(default_factory=list)


class Thesaurus:
    def __init__(self, entries=None):
        self.entries: dict[str, list[Meaning]] = defaultdict(list)
        for lemma, pos, definition, syns in entries or _BUILTIN:
            self.entries[lemma].append(Meaning(pos, definition, list(syns)))

    @classmethod
    def from_tsv(cls, path: str) -> "Thesaurus":
        rows = []
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 3:
                    syns = parts[3].split(",") if len(parts) > 3 and parts[3] else []
                    rows.append((parts[0].lower(), parts[1], parts[2], syns))
        return cls(rows)

    def lookup(self, word: str) -> list[Meaning]:
        return self.entries.get(word.lower(), [])

    def try_define(self, query: str) -> dict | None:
        """Handles 'define <word>' / '<word> definition' queries."""
        q = query.strip().lower()
        word = None
        if q.startswith("define "):
            word = q[len("define "):].strip()
        elif q.endswith(" definition"):
            word = q[: -len(" definition")].strip()
        elif q.endswith(" meaning"):
            word = q[: -len(" meaning")].strip()
        if not word or " " in word:
            return None
        meanings = self.lookup(word)
        if not meanings:
            return None
        return {
            "type": "thesaurus",
            "term": word,
            "meanings": [
                {"pos": m.pos, "definition": m.definition, "synonyms": m.synonyms}
                for m in meanings
            ],
        }
