"""Language server for .optic files — the port's copy of
stract_tpu/optics_lsp.py over the port's optics/optic.py (role of reference
crates/optics-lsp: an LSP over the optics parser giving live diagnostics,
hover docs and keyword completion in editors; the reference ships it as a
WASM VS Code extension — here it is a standard stdio LSP any editor can
launch:

    python -m stract_tpu_torch.optics_lsp

Implements the LSP subset the reference supports: initialize, didOpen/didChange
(→ publishDiagnostics from Optic.parse errors), textDocument/hover,
textDocument/completion."""

from __future__ import annotations

import json
import re
import sys

from .optics.optic import Optic, OpticError

# hover documentation for every token of the DSL (reference optics-lsp/src/docs.rs)
DOCS = {
    "Rule": "A rule filters or re-scores results. `Rule { Matches { ... }, Action(...) };`",
    "Matches": "Block of location patterns; a rule matches when ALL patterns in "
               "one Matches block match (multiple blocks are OR'ed).",
    "Action": "`Action(Boost(n))`, `Action(Downrank(n))` or `Action(Discard)` — "
              "what happens to results the rule matches.",
    "Boost": "Increase matching results' score by the given weight.",
    "Downrank": "Decrease matching results' score by the given weight.",
    "Discard": "Remove matching results entirely.",
    "DiscardNonMatching": "Only results matching at least one rule are kept.",
    "Site": 'Pattern over the result site (host), e.g. `Site("|example.com|")`. '
            "`|` anchors, `*` wildcards.",
    "Url": "Pattern over the full URL.",
    "Domain": "Pattern over the registrable domain.",
    "Title": "Pattern over the page title.",
    "Description": "Pattern over the page description.",
    "Content": "Pattern over the page text content.",
    "MicroformatTag": "Pattern over microformat tags found on the page.",
    "Schema": "Pattern over schema.org types, e.g. `Schema(\"BlogPosting\")`.",
    "Like": '`Like(Site("example.com"))` — prefer results similar to this host.',
    "Dislike": '`Dislike(Site("example.com"))` — penalize results similar to this host.',
}
COMPLETIONS = list(DOCS)

_WORD_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def _diagnostics(text: str) -> list:
    try:
        Optic.parse(text)
        return []
    except OpticError as e:
        # best effort: locate the offending token in the source
        msg = str(e)
        m = re.search(r"'([^']*)'", msg)
        line = 0
        col = 0
        if m:
            tok = m.group(1)
            for i, ln in enumerate(text.splitlines()):
                j = ln.find(tok)
                if j >= 0:
                    line, col = i, j
                    break
        return [{
            "range": {"start": {"line": line, "character": col},
                      "end": {"line": line, "character": col + 1}},
            "severity": 1,
            "source": "optics",
            "message": msg,
        }]


def _word_at(text: str, line: int, character: int) -> str | None:
    lines = text.splitlines()
    if line >= len(lines):
        return None
    for m in _WORD_RE.finditer(lines[line]):
        if m.start() <= character <= m.end():
            return m.group(0)
    return None


class OpticsLsp:
    """One LSP session over (reader, writer) byte streams."""

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        self.docs: dict[str, str] = {}
        self.running = True

    # -- wire ------------------------------------------------------------------
    def _read_message(self):
        headers = {}
        while True:
            line = self.reader.readline()
            if not line:
                return None
            line = line.strip()
            if not line:
                break
            k, _, v = line.partition(b":")
            headers[k.strip().lower()] = v.strip()
        length = int(headers.get(b"content-length", 0))
        if length <= 0:
            return None
        return json.loads(self.reader.read(length))

    def _send(self, payload: dict):
        body = json.dumps(payload).encode("utf-8")
        self.writer.write(f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        self.writer.flush()

    def _reply(self, msg_id, result):
        self._send({"jsonrpc": "2.0", "id": msg_id, "result": result})

    def _notify(self, method: str, params: dict):
        self._send({"jsonrpc": "2.0", "method": method, "params": params})

    # -- handlers ---------------------------------------------------------------
    def _publish(self, uri: str):
        self._notify("textDocument/publishDiagnostics", {
            "uri": uri, "diagnostics": _diagnostics(self.docs.get(uri, "")),
        })

    def handle(self, msg: dict):
        method = msg.get("method")
        if method == "initialize":
            self._reply(msg["id"], {
                "capabilities": {
                    "textDocumentSync": 1,  # full
                    "hoverProvider": True,
                    "completionProvider": {"triggerCharacters": ["("]},
                },
                "serverInfo": {"name": "stract-optics-lsp"},
            })
        elif method == "initialized":
            pass
        elif method == "textDocument/didOpen":
            doc = msg["params"]["textDocument"]
            self.docs[doc["uri"]] = doc["text"]
            self._publish(doc["uri"])
        elif method == "textDocument/didChange":
            p = msg["params"]
            uri = p["textDocument"]["uri"]
            if p["contentChanges"]:
                self.docs[uri] = p["contentChanges"][-1]["text"]
            self._publish(uri)
        elif method == "textDocument/hover":
            p = msg["params"]
            uri = p["textDocument"]["uri"]
            pos = p["position"]
            word = _word_at(self.docs.get(uri, ""), pos["line"], pos["character"])
            doc = DOCS.get(word or "")
            self._reply(msg["id"], {
                "contents": {"kind": "markdown", "value": f"**{word}** — {doc}"}
            } if doc else None)
        elif method == "textDocument/completion":
            self._reply(msg["id"], {
                "isIncomplete": False,
                "items": [
                    {"label": k, "kind": 14, "documentation": DOCS[k]} for k in COMPLETIONS
                ],
            })
        elif method == "shutdown":
            self._reply(msg["id"], None)
        elif method == "exit":
            self.running = False
        elif "id" in msg:  # unknown request
            self._reply(msg["id"], None)

    def serve(self):
        while self.running:
            msg = self._read_message()
            if msg is None:
                break
            self.handle(msg)


def main():
    OpticsLsp(sys.stdin.buffer, sys.stdout.buffer).serve()


if __name__ == "__main__":
    main()
