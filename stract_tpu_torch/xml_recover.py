"""A recovering XML reader for feeds and sitemaps, without lxml.

The JAX package reads feeds and sitemaps through lxml in recover mode
(`XMLParser(recover=True, resolve_entities=False, no_network=True)`); the
card's machine has no lxml, so this module reads the same bytes into the
same tree as libxml2's recovering parser builds, as far as `sitemap.py` and
`feed.py` look at it: elements (tag as lxml names it: `{uri}local` in a
declared namespace, else the name as written), attributes, text, tails,
comments, processing instructions and unresolved entity references (whose
text, as in lxml's `itertext`, is `&name;`).

The recovery rules are libxml2's (parser.c), as they show on its output:

- encoding: a UTF-8 BOM wins over the declaration; else the XML
  declaration's `encoding` at the very start of the document (a name Python
  does not know reads as UTF-8; a UTF-16 or UTF-32 label on a byte stream
  leaves no root); bytes that are not UTF-8 read as U+FFFD, one a byte;
- `\\r\\n` and a lone `\\r` read as `\\n`, in attribute values as a space;
- any end tag closes the element open at the time, whatever its name; what
  follows a name in an end tag other than blanks and `>` is text;
- a `<` that starts no name is dropped and what follows is text; a start
  tag cut short (a bad attribute, no `>`) still makes its element, empty,
  with the attributes read before the fault;
- `&name` without `;` and a bare `&` are dropped; an undefined `&name;` is
  an entity reference in text and nothing in an attribute; a bad character
  reference drops what it read (in an attribute it also ends the start
  tag);
- characters that XML does not allow are dropped from text;
- `]]>` in text of plain ASCII drops the text read since the last break in
  the parser's fast scan, and the first `]` (libxml2's
  xmlParseCharDataInternal); after a character outside ASCII the text is
  kept;
- an unterminated CDATA section, comment or processing instruction is
  dropped; the document ends where its root element ends, or at the end of
  the input with every open element closed.
"""

from __future__ import annotations

import codecs
import re

XML_NS = "http://www.w3.org/XML/1998/namespace"
_PREDEFINED = {"lt": "<", "gt": ">", "amp": "&", "apos": "'", "quot": '"'}
# libxml2's test_char_data: the ASCII its fast text scan runs over
_FAST_RUN = re.compile(r"[\t\x20-\x25\x27-\x3b\x3d-\x5c\x5e-\x7f]*")
_BLANKS = re.compile(r"[ \t\n\r]*")
_ENC_NAME = re.compile(r"[A-Za-z][A-Za-z0-9._\-]*")
_VERSION_NUM = re.compile(r"[0-9]\.[0-9]*")
_SYSTEM = re.compile(r"[^\0-\x08\x0b\x0c\x0e-\x1f\udc02\ufffe\uffff]*")
_PUBID = re.compile(r"[ \r\na-zA-Z0-9\-'()+,./:=?;!*#@$_%]*")
_NAME_START = (
    r"A-Z_a-z\xc0-\xd6\xd8-\xf6\xf8-˿Ͱ-ͽͿ-῿‌‍"
    r"⁰-↏Ⰰ-⿯、-퟿豈-﷏ﷰ-�\U00010000-\U000effff"
)
_NAME_MORE = r"\-.0-9\xb7̀-ͯ‿⁀"
_NCNAME = re.compile(f"[{_NAME_START}][{_NAME_START}{_NAME_MORE}]*")
_NAME = re.compile(f"[:{_NAME_START}][:{_NAME_START}{_NAME_MORE}]*")
_NMTOKEN = re.compile(f"[:{_NAME_START}{_NAME_MORE}]+")
_ENTITY_DECL = re.compile(f"<!ENTITY[ \\t\\n\\r]+([:{_NAME_START}][:{_NAME_START}{_NAME_MORE}]*)")


class Node:
    """An element (kind "element"), comment, processing instruction or
    entity reference; `tag` is None for the last three."""

    __slots__ = ("kind", "tag", "attrib", "text", "tail", "children")

    def __init__(self, kind: str, tag=None, attrib=None, text=None):
        self.kind = kind
        self.tag = tag
        self.attrib = attrib if attrib is not None else {}
        self.text = text
        self.tail = None
        self.children: list = []

    def __iter__(self):
        return iter(self.children)

    def get(self, key, default=None):
        return self.attrib.get(key, default)

    def itertext(self):
        """lxml's itertext: this element's text and its descendants' text
        and tails in document order (comments and processing instructions
        give their tails alone; an entity reference gives `&name;`)."""
        if self.text:
            yield self.text
        for c in self.children:
            if c.kind == "element":
                yield from c.itertext()
            elif c.kind == "entity":
                yield c.text
            if c.tail:
                yield c.tail


def _is_char(c: str) -> bool:
    o = ord(c)
    return (o >= 0x20 and o <= 0xD7FF) or o in (9, 10, 13) or (0xE000 <= o <= 0xFFFD) \
        or o >= 0x10000


# markers for bytes that are not UTF-8, as libxml2's xmlCurrentChar reads
# them: a bad byte reads as U+FFFD, a sequence cut off by the end of the
# input is dropped (lone surrogates: a UTF-8 decode never yields them)
_BAD, _CUT = "\udc01", "\udc02"


def _is_cont(b: int) -> bool:
    return b & 0xC0 == 0x80


def _cut_off(data: bytes, p: int) -> bool:
    c, avail = data[p], len(data) - p
    if avail < 2:
        return True
    if not _is_cont(data[p + 1]) or c < 0xE0:
        return False
    if avail < 3:
        return True
    if not _is_cont(data[p + 2]) or c < 0xF0:
        return False
    return avail < 4


def _libxml2_utf8(err):
    # one byte at a time, as libxml2 steps past a bad byte
    return (_CUT if _cut_off(err.object, err.start) else _BAD), err.start + 1


codecs.register_error("stract_xml_libxml2", _libxml2_utf8)


def _utf8(data: bytes) -> str:
    return data.decode("utf-8", "stract_xml_libxml2")


def _blanks(s: str, i: int) -> int:
    return _BLANKS.match(s, i).end()


def _decl_value(s: str, i: int, pattern):
    """A quoted pseudo-attribute value at s[i] → (value or None, cursor,
    error) as libxml2 reads it: the pattern's match, then the quote."""
    q = s[i]
    if q not in "\"'":
        return None, i, True  # "String not started"
    m = pattern.match(s, i + 1)
    if m is None:
        return None, i + 1, True
    j = m.end()
    if s[j] != q:
        return None, j, True  # "String not closed"
    return m.group(0), j + 1, False


def _decl_key(s: str, i: int, key: str):
    """`key` S? '=' S? at s[i] → (cursor at the value or None, error)."""
    if not s.startswith(key, i):
        return None, False
    i = _blanks(s, i + len(key))
    if s[i] != "=":
        return None, True
    return _blanks(s, i + 1), False


def _parse_decl(s: str) -> tuple:
    """xmlParseXMLDecl on a document that starts with `<?xml` and a blank
    → (the cursor past the declaration, encoding or None, standalone, error)."""
    err = False
    encoding, standalone = None, False
    i = _blanks(s, 5)
    version = None
    j, e = _decl_key(s, i, "version")
    err |= e
    if j is not None:
        version, i, e = _decl_value(s, j, _VERSION_NUM)
        err |= e
    if version is None:
        err = True  # "Malformed declaration expecting version"
    if s[i] not in " \t\n\r":
        if s.startswith("?>", i):
            return i + 2, None, False, err
        err = True  # "Blank needed here"
    i = _blanks(s, i)
    j, e = _decl_key(s, i, "encoding")
    err |= e
    if j is not None:
        encoding, i, e = _decl_value(s, j, _ENC_NAME)
        err |= e
        if encoding is not None and s[i] not in " \t\n\r":
            if s.startswith("?>", i):
                return i + 2, encoding, False, err
            err = True
    i = _blanks(s, i)
    j, e = _decl_key(s, i, "standalone")
    err |= e
    if j is not None:
        q = s[j]
        if q in "\"'":
            i = j + 1
            if s.startswith("no", i):
                i += 2
            elif s.startswith("yes", i):
                standalone, i = True, i + 3
            else:
                err = True
            if s[i] == q:
                i += 1
            else:
                err = True
        else:
            i, err = j, True
    i = _blanks(s, i)
    if s.startswith("?>", i):
        return i + 2, encoding, standalone, err
    err = True  # "parsing XML declaration: '?>' expected"
    if s[i] == ">":
        return i + 1, encoding, standalone, err
    j = s.find(">", i)
    return (len(s) if j < 0 else j + 1), encoding, standalone, err


def decode(data: bytes) -> tuple:
    """The document's characters as libxml2 reads them (bytes that are not
    UTF-8 as _BAD / _CUT markers) and whether the reading raised an error
    → (text or None where libxml2 reads no root, error)."""
    if data.startswith(b"\xef\xbb\xbf"):
        return _utf8(data[3:]), False
    for bom, enc in ((b"\xff\xfe", "utf-16-le"), (b"\xfe\xff", "utf-16-be")):
        if data.startswith(bom):
            return data[2:].decode(enc, "replace"), False
    if data.startswith(b"<\x00?\x00"):
        return data.decode("utf-16-le", "replace"), False
    if data.startswith(b"\x00<\x00?"):
        return data.decode("utf-16-be", "replace"), False
    if data.startswith(b"<?xml") and data[5:6] in (b" ", b"\t", b"\n", b"\r"):
        _, name, _, _ = _parse_decl(data[:4096].decode("latin-1") + "\0")
        if name is not None:
            written = name.upper().replace("_", "-")
            try:
                name = codecs.lookup(name).name
            except LookupError:
                name = None
            if name == "utf-8" and written not in ("UTF-8", "UTF8"):
                name = None  # Python's own aliases ("UTF", "U8"): unknown to libxml2
            if name is None:
                return _utf8(data), True  # "Unsupported encoding": read on as UTF-8
            if name.startswith(("utf-16", "utf-32")):
                return None, True
            if name != "utf-8":
                try:
                    return data.decode(name), False
                except UnicodeDecodeError as e:
                    # the conversion stops at the first byte it cannot read
                    return data[: e.start].decode(name), True
    return _utf8(data), False


class _Reader:
    """libxml2's recovering parse of a decoded document. `well_formed`
    turns False at the first error libxml2 counts as fatal; from then on it
    drops references to defined entities in text (xmlParseReference), the
    one way an earlier fault changes how later markup reads."""

    def __init__(self, s: str, well_formed: bool = True):
        self.n = len(s)
        self.s = s + "\0\0\0\0"  # lookahead past the end reads NULs, as libxml2's buffer
        self.i = 0
        self.well_formed = well_formed
        self.stack: list[tuple] = []  # (element, namespaces in scope, name as written)
        self.entities: set = set()  # general entities the internal subset declares
        self.undeclared_is_fatal = True

    def _err(self):
        self.well_formed = False

    # -- the document --------------------------------------------------------
    def document(self) -> Node | None:
        s = self.s
        if self.n == 0 or s[0] == "\0":
            return None  # "Document is empty"
        standalone = False
        if s.startswith("<?xml", 0) and s[5] in " \t\n\r":
            standalone = self._xml_decl()
        self._misc()
        if s.startswith("<!DOCTYPE", self.i):
            external = self._doctype()
            self.undeclared_is_fatal = standalone or not external
            self._misc()
        if self.i >= self.n or s[self.i] != "<":
            return None  # "Start tag expected"
        root = self._start_tag(None)
        if root is None or not self.stack:
            return root
        self._content(depth=1)
        if self.i < self.n:
            self._end_tag()
        return root

    def _xml_decl(self) -> bool:
        """xmlParseXMLDecl → standalone="yes"."""
        self.i, _, standalone, err = _parse_decl(self.s)
        if err:
            self._err()
        return standalone

    def _misc(self):
        s = self.s
        while True:
            self.i = _blanks(s, self.i)
            if s.startswith("<?", self.i):
                self._pi(None)
            elif s.startswith("<!--", self.i):
                self._comment(None)
            else:
                return

    def _literal(self, pattern) -> bool:
        """A quoted literal of the external ID at the cursor → whether it
        was read whole (else the cursor stops at the fault)."""
        s, q = self.s, self.s[self.i]
        if q not in "\"'":
            self._err()
            return False
        m = pattern.match(s, self.i + 1)
        j = m.end()
        if m.group(0).find(q) >= 0:
            j = self.i + 1 + m.group(0).find(q)
        if s[j] != q or j >= self.n:
            self._err()
            self.i = j
            return False
        if _BAD in s[self.i : j]:
            self._err()
        self.i = j + 1
        return True

    def _doctype(self) -> bool:
        """xmlParseDocTypeDecl: the name and the external ID, the internal
        subset skipped, its general entities noted → whether it names an
        external subset."""
        s, n = self.s, self.n
        self.i += 9
        if self._skip_blanks() == 0:
            self._err()
        m = _NAME.match(s, self.i)
        if m is None:
            self._err()
        else:
            self.i = m.end()
        self._skip_blanks()
        external = False
        for key, literals in (("SYSTEM", (_SYSTEM,)), ("PUBLIC", (_PUBID, _SYSTEM))):
            if s.startswith(key, self.i):
                self.i += 6
                for k, pattern in enumerate(literals):
                    if self._skip_blanks() == 0 and (k == 0 or s[self.i] in "\"'"):
                        self._err()
                    ok = self._literal(pattern)
                    external |= ok
                    if not ok:
                        break
        self._skip_blanks()
        if s[self.i] == "[":
            i = self.i + 1
            while i < n and s[i] != "]":
                if s[i] in "\"'":
                    j = s.find(s[i], i + 1, n)
                    i = n if j < 0 else j + 1
                elif s.startswith("<!--", i):
                    j = s.find("-->", i + 4, n)
                    i = n if j < 0 else j + 3
                elif s.startswith("<?", i):
                    j = s.find("?>", i + 2, n)
                    i = n if j < 0 else j + 2
                elif s.startswith("<!ENTITY", i):
                    m = _ENTITY_DECL.match(s, i)
                    if m is not None:
                        self.entities.add(m.group(1))
                    i += 8
                else:
                    i += 1
            self.i = _blanks(s, i + 1)
        if s[self.i] == ">" and self.i < n:
            self.i += 1
        else:
            self._err()  # "DOCTYPE improperly terminated": the cursor stays
        return external

    # -- content -----------------------------------------------------------------
    def _content(self, depth: int):
        s = self.s
        while self.i < self.n:
            c = s[self.i]
            if c == "<":
                c1 = s[self.i + 1]
                if c1 == "/":
                    if len(self.stack) <= depth:
                        return
                    self._end_tag()
                elif c1 == "?":
                    self._pi(self.stack[-1][0])
                elif s.startswith("<![CDATA[", self.i):
                    self._cdata()
                elif s.startswith("<!--", self.i):
                    self._comment(self.stack[-1][0])
                else:
                    self._start_tag(self.stack[-1][0])
            elif c == "&":
                self._reference()
            else:
                self._chardata()

    def _text(self, text: str):
        if not text:
            return
        parent = self.stack[-1][0]
        if parent.children:
            last = parent.children[-1]
            last.tail = (last.tail or "") + text
        else:
            parent.text = (parent.text or "") + text

    def _chardata(self):
        """libxml2's xmlParseCharDataInternal: a fast scan over plain ASCII
        that passes its text on at each stop, then the careful scan from the
        first character outside it."""
        s = self.s
        i = start = self.i
        while True:
            while s[i] in " \n":
                i += 1
            if s[i] == "<":
                self._text(s[start:i])
                self.i = i
                return
            while True:
                i = _FAST_RUN.match(s, i).end()
                if s[i] == "\n":
                    i += 1
                    continue
                if s[i] == "]":
                    if s[i + 1] == "]" and s[i + 2] == ">":
                        self._err()
                        self.i = i + 1  # the text since `start` is lost
                        return
                    i += 1
                    continue
                break
            self._text(s[start:i])
            start = i
            if s[i] == "\r" and s[i + 1] == "\n":
                start, i = i + 1, i + 2
                if s[i] in "\t\n" or 0x20 <= ord(s[i]) <= 0x7F:
                    continue
                break
            if s[i] in "<&":
                self.i = i
                return
            break  # a character outside the fast scan (never plain ASCII here)
        self.i = start
        self._chardata_complex()

    def _chardata_complex(self):
        s, i, n = self.s, self.i, self.n
        out = []
        while i < n:
            c = s[i]
            if c in "<&":
                break
            if c == "\r":
                out.append("\n")
                i += 2 if s[i + 1] == "\n" else 1
                continue
            if c == _BAD:
                self._err()
                out.append("�")
                i += 1
                continue
            if not _is_char(c):
                break
            if c == "]" and s[i + 1] == "]" and s[i + 2] == ">":
                self._err()
            out.append(c)
            i += 1
        self._text("".join(out))
        if i < n and s[i] not in "<&":
            self._err()
            i += 1  # "PCDATA invalid Char value": skipped
        self.i = i

    def _char_ref(self) -> int:
        """xmlParseCharRef at `&#`: the value (0 where it fails), the cursor
        past what it read."""
        s, i = self.s, self.i
        val = 0
        if s[i + 2] == "x":
            i += 3
            digits = "0123456789abcdefABCDEF"
            base = 16
        else:
            i += 2
            digits = "0123456789"
            base = 10
        while s[i] != ";" or i >= self.n:
            c = s[i]
            if c in digits and i < self.n:
                val = min(val * base + int(c, 16), 0x110000)
                i += 1
            else:
                self._err()
                val = 0
                break
        if s[i] == ";" and i < self.n:
            i += 1
        self.i = i
        if val >= 0x110000:
            self._err()
            return 0xFFFD
        if val == 0 or not _is_char(chr(val)):
            self._err()
        return val

    def _entity_name(self) -> str | None:
        """`&name;` → name, the cursor past it; None for a bare `&` (the `&`
        read) or a name without `;` (the `&name` read)."""
        m = _NAME.match(self.s, self.i + 1)
        if m is None:
            self._err()
            self.i += 1
            return None
        self.i = m.end()
        if self.s[self.i] != ";" or self.i >= self.n:
            self._err()
            return None
        self.i += 1
        return m.group(0)

    def _reference(self):
        if self.s[self.i + 1] == "#":
            val = self._char_ref()
            if val:
                self._text(chr(val))
            return
        name = self._entity_name()
        if name is None:
            return
        if name not in _PREDEFINED and name not in self.entities:
            if self.undeclared_is_fatal:
                self._err()
            self.stack[-1][0].children.append(Node("entity", text=f"&{name};"))
        elif not self.well_formed:
            return  # libxml2 drops a defined entity's reference after an error
        elif name in _PREDEFINED:
            self._text(_PREDEFINED[name])
        else:
            self.stack[-1][0].children.append(Node("entity", text=f"&{name};"))

    def _body(self, start: int, close: str):
        """The text from `start` to the next `close` → (text, cursor past
        it), or None (the cursor at the end or at a character XML does not
        allow, which ends the construct unterminated: dropped)."""
        s = self.s
        j = s.find(close, start, self.n)
        end = self.n if j < 0 else j
        body = s[start:end]
        bad = next((k for k, c in enumerate(body) if c != _BAD and not _is_char(c)), None)
        if bad is not None or j < 0:
            self._err()
            self.i = end if bad is None else start + bad
            return None
        if _BAD in body:
            self._err()
            body = body.replace(_BAD, "�")
        return body.replace("\r\n", "\n").replace("\r", "\n"), j + len(close)

    def _cdata(self):
        got = self._body(self.i + 9, "]]>")
        if got is not None:
            body, self.i = got
            self._text(body)

    def _comment(self, parent: Node | None):
        got = self._body(self.i + 4, "-->")
        if got is None:
            return
        body, self.i = got
        if "--" in body or body.endswith("-"):
            self._err()
        if parent is not None:
            parent.children.append(Node("comment", text=body))

    def _pi(self, parent: Node | None):
        s = self.s
        m = _NAME.match(s, self.i + 2)
        if m is None:
            self._err()
            self.i += 2  # "xmlParsePI : no target name": `<?` dropped
            return
        if m.group(0).lower() == "xml":
            self._err()
        i = m.end()
        if s.startswith("?>", i):
            self.i = i + 2
            body = ""
        else:
            if _blanks(s, i) == i:
                self._err()
            got = self._body(_blanks(s, i), "?>")
            if got is None:
                return
            body, self.i = got
        if parent is not None:
            parent.children.append(Node("pi", text=body))

    # -- tags ----------------------------------------------------------------------
    def _qname(self):
        """xmlParseQNameHashed → (prefix, local) or None, the cursor past it."""
        s, start = self.s, self.i
        m = _NCNAME.match(s, start)
        prefix, local = None, None
        if m is not None:
            local, self.i = m.group(0), m.end()
            if s[self.i] == ":":
                m2 = _NCNAME.match(s, self.i + 1)
                if m2 is not None:
                    prefix, local, self.i = local, m2.group(0), m2.end()
                else:
                    local = None
                    self.i += 1
        if local is None or s[self.i] == ":":
            if m is None and s[self.i] != ":":
                return None
            m3 = _NMTOKEN.match(s, self.i)
            if m3 is not None:
                self.i = m3.end()
            return None, s[start : self.i]
        return prefix, local

    def _skip_blanks(self) -> int:
        """Move past blanks → how many."""
        start, self.i = self.i, _blanks(self.s, self.i)
        return self.i - start

    def _att_value(self) -> str | None:
        s, n = self.s, self.n
        q = s[self.i]
        if q not in "\"'":
            self._err()
            return None  # "AttValue: \" or ' expected"
        self.i += 1
        out = []
        while True:
            if self.i >= n:
                self._err()
                return None
            c = s[self.i]
            if c == q:
                self.i += 1
                return "".join(out)
            if c == "&":
                if s[self.i + 1] == "#":
                    val = self._char_ref()
                    if not val:
                        return None
                    out.append(chr(val))
                else:
                    name = self._entity_name()
                    if name in _PREDEFINED:
                        out.append(_PREDEFINED[name])
                    elif name is not None and name not in self.entities \
                            and self.undeclared_is_fatal:
                        self._err()
                continue
            if c in "\t\n\r":
                out.append(" ")
                self.i += 2 if c == "\r" and s[self.i + 1] == "\n" else 1
                continue
            if c == "<":
                self._err()
            elif c == _BAD or not _is_char(c):
                self._err()
                c = "�"
            out.append(c)
            self.i += 1

    def _start_tag(self, parent: Node | None) -> Node | None:
        s = self.s
        self.i += 1
        name = self._qname()
        if name is None:
            self._err()
            return None  # "StartTag: invalid element name": the `<` is dropped
        attrs = []
        self._skip_blanks()
        while True:
            c = s[self.i]
            if c == ">" or (c == "/" and s[self.i + 1] == ">") or self.i >= self.n:
                break
            if not (ord(c) >= 0x20 or c in "\t\n\r"):
                break
            aname = self._qname()
            if aname is None:
                self._err()
                break  # "problem parsing attributes"
            self._skip_blanks()
            if s[self.i] == "=":
                self.i += 1
                self._skip_blanks()
                value = self._att_value()
                if value is not None:
                    attrs.append((aname, value))
            else:
                self._err()  # "Specification mandates value for attribute"
            if s[self.i] == ">" or (s[self.i] == "/" and s[self.i + 1] == ">"):
                break
            if self._skip_blanks() == 0:
                self._err()
                break  # "attributes construct error"
        node, scope = self._element(name, attrs)
        if parent is not None:
            parent.children.append(node)
        if s[self.i] == "/" and s[self.i + 1] == ">":
            self.i += 2
        elif s[self.i] == ">" and self.i < self.n:
            self.i += 1
            written = name[1] if name[0] is None else f"{name[0]}:{name[1]}"
            self.stack.append((node, scope, written))
        else:
            self._err()  # "Couldn't find end of Start Tag": the element stays, closed
        return node

    def _element(self, name, attrs) -> tuple:
        scope = dict(self.stack[-1][1]) if self.stack else {}
        plain, seen = [], set()
        for (p, local), value in attrs:
            if (p, local) in seen:
                self._err()  # "Attribute redefined": the first stays
                continue
            seen.add((p, local))
            if p is None and local == "xmlns":
                scope[None] = value
            elif p == "xmlns":
                if value:
                    scope[local] = value
            else:
                plain.append((p, local, value))
        prefix, local = name
        if prefix is None:
            uri = scope.get(None)
        elif prefix == "xml":
            uri = XML_NS
        else:
            uri = scope.get(prefix)
        if uri:
            tag = f"{{{uri}}}{local}"
        else:
            tag = local if prefix is None else f"{prefix}:{local}"
        attrib = {}
        for p, local_a, value in plain:
            if p is None:
                key = local_a
            else:
                a_uri = XML_NS if p == "xml" else scope.get(p)
                key = f"{{{a_uri}}}{local_a}" if a_uri else f"{p}:{local_a}"
            attrib.setdefault(key, value)
        return Node("element", tag, attrib), scope

    def _end_tag(self):
        """xmlParseEndTag2: closes the open element whatever the name."""
        s = self.s
        written = self.stack[-1][2]
        self.i += 2
        if s.startswith(written, self.i) and s[self.i + len(written)] in " \t\n\r>":
            self.i += len(written)
        else:
            self._err()  # "Opening and ending tag mismatch"
            m = _NAME.match(s, self.i)
            if m is not None:
                self.i = m.end()
        self._skip_blanks()
        if s[self.i] == ">" and self.i < self.n:
            self.i += 1
        else:
            self._err()
        self.stack.pop()


def fromstring(data: bytes | str) -> Node | None:
    """The root element of `data` as libxml2's recovering parser reads it,
    or None where it finds none."""
    if isinstance(data, str):
        data = data.encode("utf-8", errors="replace")
    text, error = decode(data)
    if text is None:
        return None
    return _Reader(text, well_formed=not error).document()
