"""WARC file reading/writing (role of reference warc.rs, 979 LoC: gzip WARC
records from local disk/HTTP/S3, response records with HTTP payloads).

Writer produces one gzip member per record (the standard WARC.gz layout the
crawler emits and Common Crawl uses); reader streams members and parses WARC
headers + HTTP response payloads."""

from __future__ import annotations

import gzip
import io
import uuid
from dataclasses import dataclass, field
from datetime import datetime, timezone

CRLF = b"\r\n"


@dataclass
class WarcRecord:
    url: str
    body: bytes               # decoded HTTP payload (HTML)
    record_type: str = "response"
    date: str = ""
    headers: dict = field(default_factory=dict)
    http_headers: dict = field(default_factory=dict)

    def text(self, encoding: str = "utf-8") -> str:
        return self.body.decode(encoding, errors="replace")


def _now() -> str:
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


class WarcWriter:
    """Streams gzipped WARC response records (role of crawler/warc_writer.rs)."""

    def __init__(self, fileobj):
        self.fileobj = fileobj

    @classmethod
    def open(cls, path: str) -> "WarcWriter":
        return cls(open(path, "wb"))

    def write_record(self, url: str, html: bytes | str, status: int = 200, date: str = "") -> None:
        if isinstance(html, str):
            html = html.encode("utf-8")
        http = (
            f"HTTP/1.1 {status} OK".encode() + CRLF
            + b"Content-Type: text/html; charset=utf-8" + CRLF
            + f"Content-Length: {len(html)}".encode() + CRLF + CRLF
            + html
        )
        headers = [
            b"WARC/1.0",
            b"WARC-Type: response",
            f"WARC-Record-ID: <urn:uuid:{uuid.uuid4()}>".encode(),
            f"WARC-Date: {date or _now()}".encode(),
            f"WARC-Target-URI: {url}".encode(),
            b"Content-Type: application/http;msgtype=response",
            f"Content-Length: {len(http)}".encode(),
        ]
        record = CRLF.join(headers) + CRLF + CRLF + http + CRLF + CRLF
        self.fileobj.write(gzip.compress(record))

    def close(self):
        self.fileobj.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class WarcReader:
    """Iterates response records of a .warc.gz (multi-member or single-stream)."""

    def __init__(self, fileobj):
        self.fileobj = fileobj

    @classmethod
    def open(cls, path: str) -> "WarcReader":
        return cls(open(path, "rb"))

    def __iter__(self):
        with gzip.open(self.fileobj) as gz:
            stream = io.BufferedReader(gz)
            while True:
                rec = self._read_record(stream)
                if rec is None:
                    break
                if rec.record_type == "response" and rec.url:
                    yield rec

    @staticmethod
    def _read_record(stream) -> WarcRecord | None:
        # skip blank lines between records
        line = stream.readline()
        while line in (CRLF, b"\n"):
            line = stream.readline()
        if not line:
            return None
        if not line.startswith(b"WARC/"):
            return None
        headers = {}
        while True:
            line = stream.readline()
            if line in (CRLF, b"\n", b""):
                break
            if b":" in line:
                k, v = line.split(b":", 1)
                headers[k.strip().decode().lower()] = v.strip().decode()
        length = int(headers.get("content-length", 0))
        content = stream.read(length)

        body = content
        http_headers = {}
        if headers.get("content-type", "").startswith("application/http"):
            sep = content.find(CRLF + CRLF)
            if sep != -1:
                head = content[:sep].decode("latin-1", errors="replace")
                body = content[sep + 4 :]
                for hl in head.split("\r\n")[1:]:
                    if ":" in hl:
                        k, v = hl.split(":", 1)
                        http_headers[k.strip().lower()] = v.strip()
        return WarcRecord(
            url=headers.get("warc-target-uri", ""),
            body=body,
            record_type=headers.get("warc-type", ""),
            date=headers.get("warc-date", ""),
            headers=headers,
            http_headers=http_headers,
        )
