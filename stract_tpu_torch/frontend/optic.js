/* Client-side optics parser (role of reference crates/client-wasm: parse
   .optic sources in the browser — there via wasm-bindgen over the Rust
   parser, here as a plain-JS mirror of stract_tpu/optics/optic.py's grammar).
   Exposes `OpticClient.parse(src)` → {rules, hostRankings, discardNonMatching}
   and throws OpticParseError with a useful message on bad input. The settings
   page uses it for instant validation before the server round trip. */
"use strict";

class OpticParseError extends Error {}

const TOKEN_RE = /\s+|\/\/[^\n]*|\/\*[\s\S]*?\*\/|"(?:[^"\\]|\\.)*"|-?\d+(?:\.\d+)?|[A-Za-z_][A-Za-z0-9_]*|[;,{}()]/g;
const LOCATIONS = ["Site", "Url", "Domain", "Title", "Description", "Content",
  "MicroformatTag", "Schema"];

function lex(src) {
  const out = [];
  let pos = 0;
  for (const m of src.matchAll(TOKEN_RE)) {
    if (m.index !== pos) {
      throw new OpticParseError(`unexpected character ${JSON.stringify(src[pos])}`);
    }
    pos = m.index + m[0].length;
    if (/^\s/.test(m[0]) || m[0].startsWith("//") || m[0].startsWith("/*")) continue;
    out.push(m[0]);
  }
  if (pos !== src.length) {
    throw new OpticParseError(`unexpected character ${JSON.stringify(src[pos])}`);
  }
  return out;
}

class Parser {
  constructor(tokens) { this.toks = tokens; this.i = 0; }
  peek() { return this.toks[this.i]; }
  next() {
    if (this.i >= this.toks.length) throw new OpticParseError("unexpected end of input");
    return this.toks[this.i++];
  }
  expect(v) {
    const t = this.next();
    if (t !== v) throw new OpticParseError(`expected ${v}, got ${t}`);
  }
  string() {
    const t = this.next();
    if (!t.startsWith('"')) throw new OpticParseError(`expected string, got ${t}`);
    return JSON.parse(t);
  }
  number() {
    const t = this.next();
    const n = Number(t);
    if (Number.isNaN(n)) throw new OpticParseError(`expected number, got ${t}`);
    return n;
  }
}

function parseRule(p) {
  p.expect("Rule");
  p.expect("{");
  const rule = { matches: [], action: { kind: "boost", value: 0 } };
  for (;;) {
    const t = p.peek();
    if (t === "}") { p.next(); break; }
    if (t === ",") { p.next(); continue; }
    if (t === "Matches") {
      p.next(); p.expect("{");
      const block = [];
      while (p.peek() !== "}") {
        if (p.peek() === ",") { p.next(); continue; }
        const loc = p.next();
        if (!LOCATIONS.includes(loc)) throw new OpticParseError(`unknown match location ${loc}`);
        p.expect("(");
        block.push({ location: loc, pattern: p.string() });
        p.expect(")");
      }
      p.expect("}");
      rule.matches.push(block);
    } else if (t === "Action") {
      p.next(); p.expect("(");
      const kind = p.next();
      if (kind === "Boost" || kind === "Downrank") {
        p.expect("(");
        rule.action = { kind: kind.toLowerCase(), value: p.number() };
        p.expect(")");
      } else if (kind === "Discard") {
        rule.action = { kind: "discard" };
      } else {
        throw new OpticParseError(`unknown action ${kind}`);
      }
      p.expect(")");
    } else {
      throw new OpticParseError(`unexpected token ${t} in Rule`);
    }
  }
  return rule;
}

const OpticClient = {
  OpticParseError,
  /** parse .optic source → structured optic; throws OpticParseError. */
  parse(src) {
    const p = new Parser(lex(src));
    const optic = {
      rules: [],
      hostRankings: { liked: [], disliked: [], blocked: [] },
      discardNonMatching: false,
    };
    while (p.i < p.toks.length) {
      const t = p.peek();
      if (t === ";") { p.next(); continue; }
      if (t === "DiscardNonMatching") { p.next(); optic.discardNonMatching = true; }
      else if (t === "Rule") optic.rules.push(parseRule(p));
      else if (t === "Like" || t === "Dislike") {
        p.next(); p.expect("("); p.expect("Site"); p.expect("(");
        const site = p.string();
        p.expect(")"); p.expect(")");
        (t === "Like" ? optic.hostRankings.liked : optic.hostRankings.disliked).push(site);
      } else {
        throw new OpticParseError(`unexpected token ${t}`);
      }
    }
    return optic;
  },
  /** reference client-wasm parsePreferenceOptic: source → HostRankings JSON */
  parsePreferenceOptic(src) {
    return JSON.stringify(OpticClient.parse(src).hostRankings);
  },
};

if (typeof module !== "undefined") module.exports = OpticClient;
