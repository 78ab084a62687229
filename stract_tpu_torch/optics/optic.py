"""Optics DSL — user-defined result filtering/boosting (the port's copy of
stract_tpu/optics/optic.py; role of reference
crates/optics: lexer (logos) + LALRPOP grammar (optics/src/parser.lalrpop),
Optic::parse (optics/src/lib.rs:371), Rule/Matching/Action (:400,:155,:334),
HostRankings (:472)).

Grammar (same surface language):

    // comment
    DiscardNonMatching;
    Rule {
        Matches { Site("example.com"), Title("|exact start") },
        Matches { Url("*wildcard*") },
        Action(Boost(3))            // or Downrank(2), Discard
    };
    Like(Site("good.com"));
    Dislike(Site("bad.com"));

Pattern syntax inside string literals: `*` = wildcard, `|` = anchor at
start/end. A Matches block is a conjunction of parts; a rule fires if any of
its Matches blocks matches (OR of ANDs).

Application: compile_groups lowers the Site, Domain and Url rules into
constraint groups of the device candidate plan (an excluded group for every
Discard rule and blocked host, a required group for DiscardNonMatching
membership; site and domain wildcards expanded against each segment's value
dictionary), so stages A and B and pass 2 see them as posting slots. The
rest, the residual, runs on the host over the merged candidates' stored
fields (apply): Boost/Downrank adjust candidate scores,
Discard/DiscardNonMatching drop candidates.
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass, field


class OpticError(ValueError):
    pass


class MatchLocation(enum.Enum):
    SITE = "Site"
    URL = "Url"
    DOMAIN = "Domain"
    TITLE = "Title"
    DESCRIPTION = "Description"
    CONTENT = "Content"
    MICROFORMAT_TAG = "MicroformatTag"
    SCHEMA = "Schema"


@dataclass
class Matching:
    location: MatchLocation
    pattern: str
    _re: object = None

    def compiled(self):
        if self._re is None:
            src = self.pattern
            anchored_start = src.startswith("|")
            anchored_end = src.endswith("|") and len(src) > 1
            body = src.strip("|")
            parts = [re.escape(p) for p in body.split("*")]
            rx = ".*".join(parts)
            if anchored_start:
                rx = "^" + rx
            if anchored_end:
                rx = rx + "$"
            self._re = re.compile(rx, re.IGNORECASE | re.DOTALL)
        return self._re

    def matches(self, text: str) -> bool:
        return bool(self.compiled().search(text or ""))


@dataclass
class Action:
    kind: str  # boost | downrank | discard
    value: float = 0.0


@dataclass
class Rule:
    match_blocks: list = field(default_factory=list)  # list[list[Matching]]
    action: Action = field(default_factory=lambda: Action("boost", 0.0))

    def matches(self, fields: dict) -> bool:
        """fields: location name (lower) → text. OR over blocks, AND within."""
        if not self.match_blocks:
            return True
        for block in self.match_blocks:
            if all(m.matches(fields.get(m.location.value.lower(), "")) for m in block):
                return True
        return False


@dataclass
class HostRankings:
    liked: list = field(default_factory=list)
    disliked: list = field(default_factory=list)
    blocked: list = field(default_factory=list)

    def to_json(self):
        return {"liked": self.liked, "disliked": self.disliked, "blocked": self.blocked}

    @classmethod
    def from_json(cls, d):
        return cls(d.get("liked", []), d.get("disliked", []), d.get("blocked", []))


# ---------------------------------------------------------------------------
# Lexer

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<number>-?\d+(?:\.\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<punct>[;,{}()])
    """,
    re.VERBOSE | re.DOTALL,
)


def _lex(src: str):
    tokens = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise OpticError(f"unexpected character {src[pos]!r} at offset {pos}")
        pos = m.end()
        if m.lastgroup in ("ws", "comment"):
            continue
        tokens.append((m.lastgroup, m.group(0)))
    tokens.append(("eof", ""))
    return tokens


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, value):
        kind, val = self.next()
        if val != value:
            raise OpticError(f"expected {value!r}, got {val!r}")
        return val

    def accept(self, value) -> bool:
        if self.peek()[1] == value:
            self.next()
            return True
        return False

    def string(self) -> str:
        kind, val = self.next()
        if kind != "string":
            raise OpticError(f"expected string literal, got {val!r}")
        return val[1:-1].replace('\\"', '"').replace("\\\\", "\\")

    def number(self) -> float:
        kind, val = self.next()
        if kind != "number":
            raise OpticError(f"expected number, got {val!r}")
        return float(val)


@dataclass
class Optic:
    rules: list = field(default_factory=list)
    host_rankings: HostRankings = field(default_factory=HostRankings)
    discard_non_matching: bool = False

    @classmethod
    def parse(cls, src: str) -> "Optic":
        p = _Parser(_lex(src))
        optic = cls()
        while p.peek()[0] != "eof":
            kind, val = p.peek()
            if val == ";":
                p.next()
                continue
            if val == "DiscardNonMatching":
                p.next()
                optic.discard_non_matching = True
            elif val == "Rule":
                optic.rules.append(cls._parse_rule(p))
            elif val in ("Like", "Dislike"):
                p.next()
                p.expect("(")
                p.expect("Site")
                p.expect("(")
                site = p.string()
                p.expect(")")
                p.expect(")")
                (optic.host_rankings.liked if val == "Like" else optic.host_rankings.disliked).append(site)
            else:
                raise OpticError(f"unexpected token {val!r}")
        return optic

    @staticmethod
    def _parse_rule(p: _Parser) -> Rule:
        p.expect("Rule")
        p.expect("{")
        rule = Rule()
        while True:
            kind, val = p.peek()
            if val == "}":
                p.next()
                break
            if val == ",":
                p.next()
                continue
            if val == "Matches":
                p.next()
                p.expect("{")
                block = []
                while p.peek()[1] != "}":
                    if p.accept(","):
                        continue
                    _, loc_name = p.next()
                    try:
                        loc = MatchLocation(loc_name)
                    except ValueError:
                        raise OpticError(f"unknown match location {loc_name!r}")
                    p.expect("(")
                    pattern = p.string()
                    p.expect(")")
                    block.append(Matching(loc, pattern))
                p.expect("}")
                rule.match_blocks.append(block)
            elif val == "Action":
                p.next()
                p.expect("(")
                _, action_name = p.next()
                if action_name == "Boost":
                    p.expect("(")
                    rule.action = Action("boost", p.number())
                    p.expect(")")
                elif action_name == "Downrank":
                    p.expect("(")
                    rule.action = Action("downrank", p.number())
                    p.expect(")")
                elif action_name == "Discard":
                    rule.action = Action("discard")
                else:
                    raise OpticError(f"unknown action {action_name!r}")
                p.expect(")")
            else:
                raise OpticError(f"unexpected token {val!r} in Rule")
        return rule

    # -- device compilation (role of reference query/optic.rs:1-200) -------------
    def _matching_spec(self, m: "Matching"):
        """How one Matching lowers into the device plan:
        list[(field, value)] for exact anchored patterns,
        ('pattern', dict_name, field, m) for site/domain wildcards,
        None when it can only be a host post-filter (content/title/etc.)."""
        p = m.pattern
        exact = p.startswith("|") and p.endswith("|") and len(p) > 1 and "*" not in p
        body = p.strip("|").lower()
        if m.location == MatchLocation.SITE:
            if exact:
                return [("site_no_tokenizer", body)]
            return ("pattern", "site", "site_no_tokenizer", m)
        if m.location == MatchLocation.DOMAIN:
            if exact:
                return [("domain_no_tokenizer", body)]
            return ("pattern", "domain", "domain_no_tokenizer", m)
        if m.location == MatchLocation.URL and exact:
            return [("url_no_tokenizer", body)]
        return None

    def _rule_specs(self, rule: "Rule"):
        """→ (specs, fully_compilable). A block compiles only when it is a
        single Matching (AND-of-matchings stays host-side)."""
        if not rule.match_blocks:
            return [], False
        specs = []
        for block in rule.match_blocks:
            if len(block) != 1:
                return specs, False
            s = self._matching_spec(block[0])
            if s is None:
                return specs, False
            specs.append(s)
        return specs, True

    def compile_groups(self):
        """Lower the optic into (device term groups, residual Optic).

        - Discard rules on Site/Url/Domain → ONE excluded constraint group, so
          banned docs never enter candidate generation. Wildcard-compiled
          discards also stay in the residual (expansion is capped).
        - DiscardNonMatching → ONE required constraint group IF every
          non-discard rule lowers to exact site/url/domain terms; this makes
          matching docs outside the unfiltered top-K reachable (the reference
          semantics; a host post-filter cannot do this). Otherwise membership
          filtering stays host-side.
        - Blocked hosts → merged into the excluded group (site + domain +
          www-variants).
        - Boost/Downrank rules always stay in the residual (they re-score, not
          gate, and need retrieved fields)."""
        from ..ranking.computer import OpticConstraintGroup

        groups = []
        residual_rules = []
        excl_pairs, excl_patterns = [], []
        include_pairs = []
        include_ok = True
        has_include_rule = False
        for rule in self.rules:
            specs, ok = self._rule_specs(rule)
            if rule.action.kind == "discard":
                if ok:
                    wildcard = False
                    for s in specs:
                        if isinstance(s, list):
                            excl_pairs.extend(s)
                        else:
                            excl_patterns.append(s[1:])
                            wildcard = True
                    if wildcard:
                        residual_rules.append(rule)  # cap-overflow safety net
                else:
                    residual_rules.append(rule)
            else:
                residual_rules.append(rule)
                has_include_rule = True
                if ok and all(isinstance(s, list) for s in specs):
                    for s in specs:
                        include_pairs.extend(s)
                else:
                    include_ok = False

        for host in self.host_rankings.blocked:
            h = str(host).strip().lower()
            if not h:
                continue
            variants = {h, h[4:] if h.startswith("www.") else "www." + h}
            for v in variants:
                excl_pairs.append(("site_no_tokenizer", v))
                excl_pairs.append(("domain_no_tokenizer", v))

        if excl_pairs or excl_patterns:
            groups.append(
                OpticConstraintGroup(excl_pairs, excl_patterns, required=False, excluded=True)
            )
        compiled_dnm = bool(self.discard_non_matching and has_include_rule and include_ok)
        if compiled_dnm:
            groups.append(OpticConstraintGroup(include_pairs, (), required=True))

        residual = Optic(
            rules=residual_rules,
            host_rankings=self.host_rankings,
            discard_non_matching=self.discard_non_matching and not compiled_dnm,
        )
        return groups, residual

    # -- serialization (role of reference optics/src/lib.rs:376-500 Display) ----
    def to_string(self) -> str:
        """Render optic source text that `Optic.parse` round-trips (used by the
        hosts/export and explore/export API routes, api/hosts.rs:39-48)."""
        out = []
        if self.discard_non_matching:
            out.append("DiscardNonMatching;")
        for rule in self.rules:
            out.append(self._rule_str(rule))
        for liked in self.host_rankings.liked:
            out.append(f'Like(Site("{liked}"));')
        for disliked in self.host_rankings.disliked:
            out.append(f'Dislike(Site("{disliked}"));')
        # blocked hosts render as Discard rules (reference lib.rs:488-500)
        for host in self.host_rankings.blocked:
            h = host[4:] if host.startswith("www.") else host
            out.append(
                "Rule {\n\tMatches {\n\t\t" + f'Site("|{h}|"),' + "\n\t},\n\tAction(Discard)\n};"
            )
        return "\n".join(out) + ("\n" if out else "")

    @staticmethod
    def _rule_str(rule: "Rule") -> str:
        lines = ["Rule {"]
        for block in rule.match_blocks:
            lines.append("\tMatches {")
            for m in block:
                lines.append(f'\t\t{m.location.value}("{m.pattern}"),')
            lines.append("\t},")
        a = rule.action
        if a.kind == "discard":
            lines.append("\tAction(Discard)")
        else:
            name = "Boost" if a.kind == "boost" else "Downrank"
            v = a.value
            vs = str(int(v)) if float(v).is_integer() else str(v)
            lines.append(f"\tAction({name}({vs}))")
        lines.append("};")
        return "\n".join(lines)

    # -- application -----------------------------------------------------------
    def coefficients(self) -> dict:
        return {}

    def apply(self, candidates: list, fields_of) -> list:
        """Filter/boost candidates. fields_of(candidate) → {location: text}."""
        out = []
        for c in candidates:
            fields = fields_of(c)
            if any(h and fields.get("site", "").endswith(h) for h in self.host_rankings.blocked):
                continue
            matched_any = False
            discard = False
            delta = 0.0
            for rule in self.rules:
                if rule.matches(fields):
                    matched_any = True
                    if rule.action.kind == "discard":
                        discard = True
                        break
                    elif rule.action.kind == "boost":
                        delta += rule.action.value
                    elif rule.action.kind == "downrank":
                        delta -= rule.action.value
            if discard:
                continue
            if self.discard_non_matching and self.rules and not matched_any:
                continue
            if delta:
                # multiplicative-ish boost mirroring reference optic boosts
                c.score = c.score + abs(c.score) * 0.1 * delta if c.score else delta
            out.append(c)
        return out
