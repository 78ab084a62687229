"""Calculator widget (the port's copy of stract_tpu/widgets/calculator.py;
role of reference widgets/calculator — fend-core based).

Safe recursive-descent evaluator: + − × ÷ ^ % parens, unary minus, constants
(pi, e) and functions (sqrt, sin, cos, tan, log, ln, abs, round)."""

from __future__ import annotations

import math
import re

_TOKEN = re.compile(r"\s*(?:(\d+\.?\d*|\.\d+)|([A-Za-z]+)|(.))")

_FUNCS = {
    "sqrt": math.sqrt, "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "log": math.log10, "ln": math.log, "abs": abs, "round": round,
    "exp": math.exp, "floor": math.floor, "ceil": math.ceil,
}
_CONSTS = {"pi": math.pi, "e": math.e, "tau": math.tau}


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expr(self):
        v = self.term()
        while self.peek() in ("+", "-"):
            op = self.next()
            r = self.term()
            v = v + r if op == "+" else v - r
        return v

    def term(self):
        v = self.factor()
        while self.peek() in ("*", "/", "%", "x", "×", "÷"):
            op = self.next()
            r = self.factor()
            if op in ("*", "x", "×"):
                v *= r
            elif op in ("/", "÷"):
                v /= r
            else:
                v %= r
        return v

    def factor(self):
        v = self.unary()
        if self.peek() in ("^", "**"):
            self.next()
            return v ** self.factor()  # right assoc
        return v

    def unary(self):
        if self.peek() == "-":
            self.next()
            return -self.unary()
        if self.peek() == "+":
            self.next()
            return self.unary()
        return self.atom()

    def atom(self):
        t = self.next()
        if t is None:
            raise ValueError("unexpected end")
        if isinstance(t, float):
            # trailing % is "percent" only when not followed by an operand (else modulo)
            if self.peek() == "%":
                after = self.toks[self.i + 1] if self.i + 1 < len(self.toks) else None
                if after is None or after == ")":
                    self.next()
                    return t / 100.0
            return t
        if isinstance(t, str) and t.lower() in _CONSTS:
            return _CONSTS[t.lower()]
        if isinstance(t, str) and t.lower() in _FUNCS:
            if self.peek() != "(":
                raise ValueError(f"expected ( after {t}")
            self.next()
            arg = self.expr()
            if self.next() != ")":
                raise ValueError("expected )")
            return _FUNCS[t.lower()](arg)
        if t == "(":
            v = self.expr()
            if self.next() != ")":
                raise ValueError("expected )")
            return v
        raise ValueError(f"unexpected token {t!r}")


def _lex(s: str):
    out = []
    i = 0
    while i < len(s):
        m = _TOKEN.match(s, i)
        if not m:
            break
        i = m.end()
        num, word, punct = m.groups()
        if num is not None:
            out.append(float(num))
        elif word is not None:
            out.append(word)
        elif punct and not punct.isspace():
            if punct == "*" and out and out[-1] == "*":
                out[-1] = "**"
            else:
                out.append(punct)
    return out


class Calculator:
    def try_calculate(self, query: str) -> dict | None:
        """→ widget dict {'type': 'calculator', 'input', 'result'} or None."""
        q = query.strip().rstrip("=").strip()
        toks = _lex(q)
        # must contain at least one operator or function to be a calc query
        has_op = any(t in ("+", "-", "*", "/", "%", "^", "**", "x", "×", "÷") for t in toks if isinstance(t, str))
        has_fn = any(isinstance(t, str) and t.lower() in _FUNCS for t in toks)
        has_num = any(isinstance(t, float) for t in toks)
        if not (has_num and (has_op or has_fn)):
            return None
        try:
            p = _Parser(toks)
            result = p.expr()
            if p.peek() is not None:
                return None
        except (ValueError, ZeroDivisionError, OverflowError):
            return None
        if result == int(result) and abs(result) < 1e15:
            text = str(int(result))
        else:
            text = f"{result:.10g}"
        return {"type": "calculator", "input": q, "result": text}
