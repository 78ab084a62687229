"""ZIM file reader — the port's copy of stract_tpu/zim.py (role of reference crates/zimba, 1,095 LoC: reads Wikipedia
ZIM dumps for entity-index construction, entrypoint/entity.rs:18).

Implements the openzim spec subset needed for article iteration: header, MIME
list, URL pointer list, directory entries (content + redirect), clusters with
none/lzma/zstd compression, normal and extended (8-byte) blob offsets.

Also provides `ZimWriter`, a minimal uncompressed-cluster writer (the
reference tests against a downloaded test.zim; the tests and chip_smoke.py
write their ZIM files with it instead). Both read and write the JAX package's
layout byte for byte."""

from __future__ import annotations

import io
import lzma
import struct
from dataclasses import dataclass

ZIM_MAGIC = 0x44D495A


@dataclass
class DirEnt:
    namespace: str
    url: str
    title: str
    mimetype: int
    cluster: int = 0
    blob: int = 0
    redirect_index: int | None = None

    @property
    def is_redirect(self) -> bool:
        return self.redirect_index is not None


@dataclass
class Article:
    url: str
    title: str
    content: bytes
    mimetype: str

    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")


class ZimFile:
    def __init__(self, path: str):
        self.f = open(path, "rb")
        header = self.f.read(80)
        if len(header) < 80:
            self.f.close()
            raise ValueError("truncated ZIM header")
        (magic, self.major, self.minor) = struct.unpack_from("<IHH", header, 0)
        if magic != ZIM_MAGIC:
            self.f.close()
            raise ValueError("not a ZIM file")
        (self.entry_count, self.cluster_count) = struct.unpack_from("<II", header, 24)
        (self.url_ptr_pos, self.title_ptr_pos, self.cluster_ptr_pos, self.mime_list_pos) = (
            struct.unpack_from("<QQQQ", header, 32)
        )
        (self.main_page, self.layout_page) = struct.unpack_from("<II", header, 64)
        self._read_mime_list()
        self._url_ptrs = None
        self._cluster_ptrs = None
        self._cluster_cache: dict[int, list[bytes]] = {}

    def _read_mime_list(self):
        self.f.seek(self.mime_list_pos)
        data = self.f.read(8192)
        self.mimetypes = []
        pos = 0
        while pos < len(data):
            end = data.find(b"\x00", pos)
            if end == pos or end == -1:
                break
            self.mimetypes.append(data[pos:end].decode("utf-8", errors="replace"))
            pos = end + 1

    def _url_pointers(self):
        if self._url_ptrs is None:
            self.f.seek(self.url_ptr_pos)
            data = self.f.read(8 * self.entry_count)
            if len(data) < 8 * self.entry_count:
                raise ValueError("truncated ZIM url pointer list")
            self._url_ptrs = struct.unpack(f"<{self.entry_count}Q", data)
        return self._url_ptrs

    def _cluster_pointers(self):
        if self._cluster_ptrs is None:
            self.f.seek(self.cluster_ptr_pos)
            data = self.f.read(8 * self.cluster_count)
            if len(data) < 8 * self.cluster_count:
                raise ValueError("truncated ZIM cluster pointer list")
            self._cluster_ptrs = struct.unpack(f"<{self.cluster_count}Q", data)
        return self._cluster_ptrs

    def dirent(self, index: int) -> DirEnt:
        self.f.seek(self._url_pointers()[index])
        data = self.f.read(4096)
        if len(data) < 16:
            raise ValueError("truncated ZIM dirent")
        (mimetype,) = struct.unpack_from("<H", data, 0)
        namespace = chr(data[3])
        if mimetype == 0xFFFF:  # redirect
            (redirect_index,) = struct.unpack_from("<I", data, 8)
            rest = data[12:]
            url, title = _two_cstrings(rest)
            return DirEnt(namespace, url, title, mimetype, redirect_index=redirect_index)
        cluster, blob = struct.unpack_from("<II", data, 8)
        url, title = _two_cstrings(data[16:])
        return DirEnt(namespace, url, title, mimetype, cluster=cluster, blob=blob)

    def _cluster_blobs(self, cluster_idx: int) -> list[bytes]:
        if cluster_idx in self._cluster_cache:
            return self._cluster_cache[cluster_idx]
        ptrs = self._cluster_pointers()
        start = ptrs[cluster_idx]
        end = ptrs[cluster_idx + 1] if cluster_idx + 1 < len(ptrs) else None
        self.f.seek(start)
        raw = self.f.read((end - start) if end else 64 << 20)
        comp = raw[0] & 0x0F
        extended = bool(raw[0] & 0x10)
        body = raw[1:]
        if comp in (0, 1):
            pass
        elif comp == 4:
            body = lzma.decompress(body, format=lzma.FORMAT_XZ)
        elif comp == 5:
            import zstandard

            body = zstandard.ZstdDecompressor().decompressobj().decompress(body)
        else:
            raise ValueError(f"unsupported cluster compression {comp}")
        osize = 8 if extended else 4
        fmt = "<Q" if extended else "<I"
        (first_off,) = struct.unpack_from(fmt, body, 0)
        n_blobs = first_off // osize - 1
        offsets = struct.unpack_from(f"<{n_blobs + 1}{'Q' if extended else 'I'}", body, 0)
        blobs = [body[offsets[i] : offsets[i + 1]] for i in range(n_blobs)]
        self._cluster_cache[cluster_idx] = blobs
        return blobs

    def content(self, d: DirEnt) -> bytes:
        return self._cluster_blobs(d.cluster)[d.blob]

    def articles(self, namespaces=("A", "C")) -> "iter[Article]":
        """Iterate content entries (v5: 'A' article namespace; v6: 'C')."""
        for i in range(self.entry_count):
            d = self.dirent(i)
            if d.namespace not in namespaces or d.is_redirect:
                continue
            mt = self.mimetypes[d.mimetype] if d.mimetype < len(self.mimetypes) else ""
            if mt and not mt.startswith("text/html"):
                continue
            yield Article(d.url, d.title or d.url, self.content(d), mt)

    def close(self):
        self.f.close()


def _two_cstrings(data: bytes) -> tuple[str, str]:
    end1 = data.find(b"\x00")
    end2 = data.find(b"\x00", end1 + 1)
    return (
        data[:end1].decode("utf-8", errors="replace"),
        data[end1 + 1 : end2].decode("utf-8", errors="replace"),
    )


class ZimWriter:
    """Minimal valid ZIM writer (uncompressed, one cluster) for tests/dev."""

    def __init__(self):
        self.entries: list[tuple[str, str, str, bytes]] = []  # (ns, url, title, html)

    def add_article(self, url: str, title: str, html: str, namespace: str = "A"):
        self.entries.append((namespace, url, title, html.encode("utf-8")))

    def write(self, path: str) -> None:
        mimes = b"text/html\x00\x00"
        blobs = [e[3] for e in self.entries]
        osize = 4
        offsets = []
        pos = (len(blobs) + 1) * osize
        for b in blobs:
            offsets.append(pos)
            pos += len(b)
        offsets.append(pos)
        cluster = bytes([1]) + struct.pack(f"<{len(offsets)}I", *offsets) + b"".join(blobs)

        dirents = []
        for i, (ns, url, title, _) in enumerate(self.entries):
            d = struct.pack("<HBc", 0, 0, ns.encode()) + struct.pack("<I", 0)
            d += struct.pack("<II", 0, i)
            d += url.encode() + b"\x00" + title.encode() + b"\x00"
            dirents.append(d)

        header_size = 80
        mime_pos = header_size
        url_ptr_pos = mime_pos + len(mimes)
        dirent_start = url_ptr_pos + 8 * len(dirents)
        url_ptrs = []
        pos = dirent_start
        for d in dirents:
            url_ptrs.append(pos)
            pos += len(d)
        title_ptr_pos = pos  # title pointers (u32 indices into url ptr list)
        cluster_ptr_pos = title_ptr_pos + 4 * len(dirents)
        cluster_pos = cluster_ptr_pos + 8
        checksum_pos = cluster_pos + len(cluster)

        header = struct.pack(
            "<IHH16sIIQQQQIIQ",
            ZIM_MAGIC, 5, 0, b"\x00" * 16,
            len(dirents), 1,
            url_ptr_pos, title_ptr_pos, cluster_ptr_pos, mime_pos,
            0xFFFFFFFF, 0xFFFFFFFF, checksum_pos,
        )
        with open(path, "wb") as fh:
            fh.write(header)
            fh.write(mimes)
            fh.write(struct.pack(f"<{len(url_ptrs)}Q", *url_ptrs))
            for d in dirents:
                fh.write(d)
            fh.write(struct.pack(f"<{len(dirents)}I", *range(len(dirents))))
            fh.write(struct.pack("<Q", cluster_pos))
            fh.write(cluster)
            fh.write(b"\x00" * 16)
