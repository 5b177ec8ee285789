"""Dependency-free PDF text extraction.

The reference parses PDFs exclusively through docling (reference
src/pdf_parsing.py:134-162) — a torch/layout-model stack that is optional
in this framework.  This module gives ``parse-pdfs`` a built-in path for
**digital-text PDFs** (the annual-report case: text layers produced by
office/print pipelines) with zero dependencies:

* object scavenging: every ``N G obj … endobj`` in the file is parsed
  directly — no xref table/stream handling, so damaged or incrementally
  updated files still extract; ``/Type /ObjStm`` object streams
  (PDF 1.5+ compressed xref layouts) are unpacked the same way;
* ``FlateDecode`` content streams (zlib), literal/hex strings with the
  full escape set, ``Tj``/``TJ``/``'``/``"`` text operators with
  line-break heuristics from ``Td``/``TD``/``T*``/``Tm``;
* **CJK support**: ``/ToUnicode`` CMaps (``bfchar``/``bfrange``, array
  and incrementing forms) decode CID-keyed ``/Type0`` fonts — the
  encoding every digitally-produced Chinese PDF ships; simple fonts fall
  back to Latin-1.

Scanned/image-only PDFs need OCR and remain docling's job; tables come
out as plain text lines (no structure recovery).  The page-text output
feeds the same parsed-report contract as PlainTextParser.

Port of ``rag_challenge_2_tpu/ingestion/minipdf.py`` (host code:
a copy with the imports pointed at the port).
"""

from __future__ import annotations

import re
import zlib
from typing import Dict, List, Optional, Tuple, Union

Ref = Tuple[str, int]          # ("ref", object number)
PdfObj = Union[dict, list, bytes, str, int, float, bool, None, Ref]

_WS = b"\x00\t\n\x0c\r "
_DELIM = b"()<>[]{}/%"


class _Lexer:
    """Tokenizer over raw PDF bytes (objects and content streams share
    the same syntax for everything but operators)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def _skip_ws(self) -> None:
        d, n = self.data, len(self.data)
        while self.pos < n:
            c = d[self.pos]
            if c in _WS:
                self.pos += 1
            elif c == 0x25:  # '%' comment
                e = d.find(b"\n", self.pos)
                self.pos = len(d) if e < 0 else e + 1
            else:
                return

    def next_token(self):
        """Returns one of: ('dict', {...}) ('array', [...]) ('name', str)
        ('num', int|float) ('str', bytes) ('kw', bytes) or None at end."""
        self._skip_ws()
        d, n = self.data, len(self.data)
        if self.pos >= n:
            return None
        c = d[self.pos]
        if d.startswith(b"<<", self.pos):
            return ("dict", self._parse_dict())
        if c == 0x3C:  # '<' hex string
            return ("str", self._parse_hex_string())
        if c == 0x28:  # '(' literal string
            return ("str", self._parse_lit_string())
        if c == 0x5B:  # '['
            return ("array", self._parse_array())
        if c == 0x2F:  # '/'
            return ("name", self._parse_name())
        if c == 0x5D:  # ']'
            self.pos += 1
            return ("kw", b"]")
        if d.startswith(b">>", self.pos):
            self.pos += 2
            return ("kw", b">>")
        # number or keyword/operator
        m = re.compile(rb"[+-]?(?:\d+\.\d*|\.\d+|\d+)").match(d, self.pos)
        if m and m.start() == self.pos:
            self.pos = m.end()
            t = m.group()
            return ("num", float(t) if b"." in t else int(t))
        m = re.compile(rb"[^\x00\t\n\x0c\r ()<>\[\]{}/%]+").match(d, self.pos)
        if m:
            self.pos = m.end()
            return ("kw", m.group())
        self.pos += 1  # lone delimiter; skip
        return ("kw", d[self.pos - 1 : self.pos])

    def _parse_name(self) -> str:
        m = re.compile(rb"/([^\x00\t\n\x0c\r ()<>\[\]{}/%]*)").match(
            self.data, self.pos
        )
        self.pos = m.end()
        raw = m.group(1)
        # #XX hex escapes in names
        return re.sub(
            rb"#([0-9A-Fa-f]{2})", lambda g: bytes([int(g.group(1), 16)]), raw
        ).decode("latin-1")

    def _parse_lit_string(self) -> bytes:
        d = self.data
        i = self.pos + 1
        depth, out = 1, bytearray()
        while i < len(d):
            c = d[i]
            if c == 0x5C:  # backslash
                i += 1
                if i >= len(d):
                    break
                e = d[i]
                if e in b"nrtbf":
                    out += {0x6E: b"\n", 0x72: b"\r", 0x74: b"\t",
                            0x62: b"\b", 0x66: b"\f"}[e]
                    i += 1
                elif e in b"()\\":
                    out.append(e)
                    i += 1
                elif 0x30 <= e <= 0x37:  # octal, up to 3 digits
                    j = i
                    while j < len(d) and j - i < 3 and 0x30 <= d[j] <= 0x37:
                        j += 1
                    out.append(int(d[i:j], 8) & 0xFF)
                    i = j
                elif e in b"\r\n":  # line continuation
                    i += 1
                    if e == 0x0D and i < len(d) and d[i] == 0x0A:
                        i += 1
                else:
                    out.append(e)
                    i += 1
            elif c == 0x28:
                depth += 1
                out.append(c)
                i += 1
            elif c == 0x29:
                depth -= 1
                if depth == 0:
                    i += 1
                    break
                out.append(c)
                i += 1
            else:
                out.append(c)
                i += 1
        self.pos = i
        return bytes(out)

    def _parse_hex_string(self) -> bytes:
        e = self.data.find(b">", self.pos)
        if e < 0:
            e = len(self.data)
        hx = re.sub(rb"[^0-9A-Fa-f]", b"", self.data[self.pos + 1 : e])
        self.pos = e + 1
        if len(hx) % 2:
            hx += b"0"
        return bytes.fromhex(hx.decode("ascii"))

    def _parse_array(self) -> list:
        self.pos += 1
        out: list = []
        while True:
            self._skip_ws()
            if self.pos >= len(self.data):
                break
            if self.data[self.pos] == 0x5D:
                self.pos += 1
                break
            out.append(self._parse_value())
        return out

    def _parse_dict(self) -> dict:
        self.pos += 2
        out: dict = {}
        while True:
            self._skip_ws()
            if self.data.startswith(b">>", self.pos):
                self.pos += 2
                break
            if self.pos >= len(self.data):
                break
            if self.data[self.pos] != 0x2F:  # malformed key; bail out
                self.pos += 1
                continue
            key = self._parse_name()
            out[key] = self._parse_value()
        return out

    def _parse_value(self) -> PdfObj:
        tok = self.next_token()
        if tok is None:
            return None
        kind, val = tok
        if kind == "num" and isinstance(val, int):
            # lookahead for "G R" (indirect reference)
            save = self.pos
            t2 = self.next_token()
            if t2 and t2[0] == "num" and isinstance(t2[1], int):
                t3 = self.next_token()
                if t3 == ("kw", b"R"):
                    return ("ref", val)
                self.pos = save
                return val
            self.pos = save
            return val
        if kind == "kw":
            if val == b"true":
                return True
            if val == b"false":
                return False
            if val == b"null":
                return None
            return ("kw", val)
        return val


_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b", re.S)
_STREAM_RE = re.compile(rb"stream\r?\n")


class _Document:
    """Scavenged object table + helpers."""

    def __init__(self, data: bytes):
        self.data = data
        self.objects: Dict[int, PdfObj] = {}
        self.streams: Dict[int, bytes] = {}
        self._fonts: Dict[int, "_Font"] = {}
        self._scavenge()
        # strings/streams of an encrypted file are ciphertext — extraction
        # would emit garbage, so surface it instead (trailer /Encrypt key,
        # classic or xref-stream layout)
        self.encrypted = any(
            isinstance(v, dict) and "Encrypt" in v
            and v.get("Type") in (None, "XRef")
            for v in self.objects.values()
        ) or bool(re.search(rb"trailer\b[^>]{0,512}?/Encrypt\b", data, re.S))

    # -- object table -----------------------------------------------------
    def _scavenge(self) -> None:
        d = self.data
        pending: List[Tuple[int, dict, bytes]] = []
        for m in _OBJ_RE.finditer(d):
            num = int(m.group(1))
            body_start = m.end()
            end = d.find(b"endobj", body_start)
            if end < 0:
                end = len(d)
            lex = _Lexer(d, body_start)
            try:
                val = lex._parse_value()
            except Exception:
                continue
            self.objects[num] = val
            sm = _STREAM_RE.search(d, lex.pos, end + 7)
            if sm and isinstance(val, dict):
                raw_end = d.find(b"endstream", sm.end())
                if raw_end < 0:
                    raw_end = end
                pending.append((num, val, d[sm.end() : raw_end].rstrip(b"\r\n")))
        # decode AFTER the object table is complete so /Filter and /Subtype
        # entries that are indirect references resolve correctly
        for num, val, raw in pending:
            if self.resolve(val.get("Subtype")) == "Image":
                continue   # bitmap data, never read as text — don't
                           # decompress it (10-100x inflation per image)
            self.streams[num] = self._decode_stream(val, raw)
        # unpack object streams (PDF 1.5 compressed objects)
        for num, val in list(self.objects.items()):
            if isinstance(val, dict) and val.get("Type") == "ObjStm":
                self._unpack_objstm(val, self.streams.get(num, b""))

    def _decode_stream(self, sdict: dict, raw: bytes) -> bytes:
        filt = self.resolve(sdict.get("Filter"))
        filters = filt if isinstance(filt, list) else [filt] if filt else []
        out = raw
        for f in filters:
            f = self.resolve(f)    # filter entries may be indirect refs
            if f == "FlateDecode":
                try:
                    out = zlib.decompress(out)
                except zlib.error:
                    try:  # tolerate trailing garbage
                        out = zlib.decompressobj().decompress(out)
                    except zlib.error:
                        return b""
            else:      # image/exotic/unresolvable filters: not text —
                       # never pass still-compressed bytes through
                return b""
        return out

    def _unpack_objstm(self, sdict: dict, data: bytes) -> None:
        try:
            n = int(self.resolve(sdict.get("N")) or 0)
            first = int(self.resolve(sdict.get("First")) or 0)
        except (TypeError, ValueError):
            return
        head = data[:first].split()
        for i in range(n):
            try:
                num = int(head[2 * i])
                off = int(head[2 * i + 1])
            except (IndexError, ValueError):
                return
            if num in self.objects:
                continue
            lex = _Lexer(data, first + off)
            try:
                self.objects[num] = lex._parse_value()
            except Exception:
                continue

    def resolve(self, obj: PdfObj, depth: int = 0) -> PdfObj:
        while (
            isinstance(obj, tuple) and len(obj) == 2 and obj[0] == "ref"
            and depth < 32
        ):
            obj = self.objects.get(obj[1])
            depth += 1
        return obj

    # -- page tree ----------------------------------------------------------
    def page_objects(self) -> List[dict]:
        """Pages in tree order when the catalog resolves, else file order."""
        catalog = next(
            (v for v in self.objects.values()
             if isinstance(v, dict) and v.get("Type") == "Catalog"),
            None,
        )
        pages: List[dict] = []
        if catalog is not None:
            seen: set = set()

            def walk(node: PdfObj) -> None:
                node = self.resolve(node)
                if not isinstance(node, dict) or id(node) in seen:
                    return
                seen.add(id(node))
                t = node.get("Type")
                if t == "Page":
                    pages.append(node)
                else:
                    for kid in self.resolve(node.get("Kids")) or []:
                        walk(kid)

            walk(catalog.get("Pages"))
        if not pages:
            pages = [
                v for _, v in sorted(self.objects.items())
                if isinstance(v, dict) and v.get("Type") == "Page"
            ]
        return pages

    def content_bytes(self, page: dict) -> bytes:
        c = page.get("Contents")
        # /Contents may be an indirect reference TO an array of stream refs
        # (common after incremental edits) — resolve before the list check
        if isinstance(c, tuple) and c and c[0] == "ref":
            target = self.objects.get(c[1])
            if isinstance(target, list):
                c = target
        refs = c if isinstance(c, list) else [c]
        out = []
        for r in refs:
            if isinstance(r, tuple) and r[0] == "ref":
                out.append(self.streams.get(r[1], b""))
        return b"\n".join(out)

    def page_resources(self, page: dict) -> Optional[dict]:
        """/Resources with PDF-spec inheritance: absent on the page, walk
        /Parent up the Pages tree (many generators put one shared dict on
        the root Pages node)."""
        node: PdfObj = page
        for _ in range(32):
            if not isinstance(node, dict):
                return None
            r = self.resolve(node.get("Resources"))
            if isinstance(r, dict):
                return r
            node = self.resolve(node.get("Parent"))
        return None


_BFCHAR_RE = re.compile(
    rb"beginbfchar(.*?)endbfchar", re.S)
_BFRANGE_RE = re.compile(
    rb"beginbfrange(.*?)endbfrange", re.S)
_HEX_RE = re.compile(rb"<([0-9A-Fa-f]+)>")


def _utf16(hx: bytes) -> str:
    if len(hx) % 2:       # odd digit count in a malformed CMap entry
        hx += b"0"
    b = bytes.fromhex(hx.decode("ascii"))
    if len(b) % 2:
        b += b"\x00"
    return b.decode("utf-16-be", errors="ignore")


class _Font:
    """Per-font string decoder: ToUnicode CMap when present (2-byte codes
    for /Type0 composite fonts, 1-byte otherwise), Latin-1 fallback."""

    def __init__(self, doc: _Document, fd: dict):
        self.two_byte = fd.get("Subtype") == "Type0"
        self.cmap: Optional[Dict[int, str]] = None
        tu = fd.get("ToUnicode")
        if isinstance(tu, tuple) and tu[0] == "ref":
            data = doc.streams.get(tu[1])
            if data:
                try:
                    self.cmap = self._parse_cmap(data)
                except Exception:   # a broken CMap must not kill the
                    self.cmap = None  # whole extraction (damaged-file scope)

    @staticmethod
    def _parse_cmap(data: bytes) -> Dict[int, str]:
        out: Dict[int, str] = {}
        for block in _BFCHAR_RE.findall(data):
            hexes = _HEX_RE.findall(block)
            for i in range(0, len(hexes) - 1, 2):
                out[int(hexes[i], 16)] = _utf16(hexes[i + 1])
        for block in _BFRANGE_RE.findall(data):
            # two forms: <lo> <hi> <dst>  |  <lo> <hi> [<d0> <d1> ...]
            lex = _Lexer(block)
            while True:
                t = lex.next_token()
                if t is None:
                    break
                if t[0] != "str":
                    continue
                lo = int.from_bytes(t[1], "big")
                t2 = lex.next_token()
                if not t2 or t2[0] != "str":
                    continue
                hi = int.from_bytes(t2[1], "big")
                t3 = lex.next_token()
                if t3 and t3[0] == "array":
                    for k, dst in enumerate(t3[1]):
                        if isinstance(dst, bytes) and lo + k <= hi:
                            out[lo + k] = dst.decode(
                                "utf-16-be", errors="ignore")
                elif t3 and t3[0] == "str":
                    base = int.from_bytes(t3[1], "big")
                    width = max(len(t3[1]), 2)
                    for code in range(lo, hi + 1):
                        v = base + code - lo
                        # a malformed range may overflow the destination
                        # width — widen rather than raise
                        nb = max(width, -(-v.bit_length() // 8) or 1)
                        out[code] = v.to_bytes(
                            nb, "big").decode("utf-16-be", errors="ignore")
        return out

    def decode(self, raw: bytes) -> str:
        if self.cmap is not None:
            step = 2 if self.two_byte else 1
            chars = []
            for i in range(0, len(raw) - step + 1, step):
                code = int.from_bytes(raw[i : i + step], "big")
                chars.append(self.cmap.get(code, ""))
            return "".join(chars)
        return raw.decode("latin-1", errors="ignore")


_DEFAULT_FONT = _Font.__new__(_Font)
_DEFAULT_FONT.cmap = None
_DEFAULT_FONT.two_byte = False


def _fonts_of(doc: _Document, resources: Optional[dict]) -> Dict[str, _Font]:
    fonts = doc.resolve((resources or {}).get("Font")) or {}
    out = {}
    for name, ref in fonts.items():
        # one CJK font (multi-thousand-entry CMap) is typically shared by
        # every page — cache the parsed _Font by object number
        if isinstance(ref, tuple) and ref and ref[0] == "ref":
            cached = doc._fonts.get(ref[1])
            if cached is None:
                fd = doc.resolve(ref)
                if not isinstance(fd, dict):
                    continue
                cached = doc._fonts[ref[1]] = _Font(doc, fd)
            out[name] = cached
            continue
        fd = doc.resolve(ref)
        if isinstance(fd, dict):
            out[name] = _Font(doc, fd)
    return out


def _interpret_page(
    doc: _Document, page: dict
) -> Tuple[List[str], List[Optional[float]], List[Tuple[float, float, str]]]:
    """Interpret the page's content stream text operators.

    Returns ``(lines, line_ys, runs)``: the line-broken text (the
    original heuristics), each line's device-space y (of its first glyph
    run; None for lines that never got one), and the positioned text runs
    ``(x, y, text)`` — one per show operator, at the line-matrix origin —
    that feed the table-grid detector (:func:`_detect_tables`)."""
    lines: List[str] = [""]
    line_ys: List[Optional[float]] = [None]
    runs: List[Tuple[float, float, str]] = []
    # text line matrix [a b c d e f] (PDF 9.4.2) — tracked so every show
    # op knows its origin.  Identity outside BT/ET; Tm sets it, Td/TD/T*
    # translate it in text space.
    lm = [1.0, 0.0, 0.0, 1.0, 0.0, 0.0]
    leading = [0.0]

    def emit(s: str) -> None:
        if not s:
            return
        if line_ys[-1] is None:
            line_ys[-1] = lm[5]
        lines[-1] += s
        if runs and runs[-1][0] == lm[4] and runs[-1][1] == lm[5]:
            runs[-1] = (lm[4], lm[5], runs[-1][2] + s)
        else:
            runs.append((lm[4], lm[5], s))

    def newline() -> None:
        if lines[-1]:
            lines.append("")
            line_ys.append(None)

    def translate(tx: float, ty: float) -> None:
        lm[4] += lm[0] * tx + lm[2] * ty
        lm[5] += lm[1] * tx + lm[3] * ty

    def run(content: bytes, resources: Optional[dict], depth: int) -> None:
        fonts = _fonts_of(doc, resources)
        xobjs = doc.resolve((resources or {}).get("XObject")) or {}
        lex = _Lexer(content)
        font = _DEFAULT_FONT
        stack: List = []
        cur_y: Optional[float] = None

        def nums(n: int) -> List[float]:
            vals = [v for k, v in stack[-n:] if k == "num"]
            return vals if len(vals) == n else []

        while True:
            tok = lex.next_token()
            if tok is None:
                break
            kind, val = tok
            if kind != "kw":
                stack.append((kind, val))
                continue
            op = val
            if op == b"Tf" and len(stack) >= 2 and stack[-2][0] == "name":
                font = fonts.get(stack[-2][1], _DEFAULT_FONT)
            elif op == b"Tj" and stack and stack[-1][0] == "str":
                emit(font.decode(stack[-1][1]))
            elif op in (b"'", b'"'):
                newline()
                translate(0.0, -leading[0])
                strs = [v for k, v in stack if k == "str"]
                if strs:
                    emit(font.decode(strs[-1]))
            elif op == b"TJ" and stack and stack[-1][0] == "array":
                for el in stack[-1][1]:
                    if isinstance(el, bytes):
                        emit(font.decode(el))
                    elif isinstance(el, (int, float)) and el < -180:
                        emit(" ")          # large kern ≈ word gap
            elif op in (b"Td", b"TD") and len(stack) >= 2:
                v = nums(2)
                tx, ty = v if v else (0.0, 0.0)
                if op == b"TD":
                    leading[0] = -ty
                translate(tx, ty)
                if ty != 0:
                    newline()
            elif op == b"TL" and stack and stack[-1][0] == "num":
                leading[0] = stack[-1][1]
            elif op == b"T*":
                translate(0.0, -leading[0])
                newline()
            elif op == b"Tm" and len(stack) >= 6:
                v = nums(6)
                if v:
                    y = v[5]
                    if cur_y is not None and y != cur_y:
                        newline()
                    cur_y = y
                    lm[:] = v
            elif op == b"BT":
                cur_y = None
                lm[:] = [1.0, 0.0, 0.0, 1.0, 0.0, 0.0]
            elif op == b"ET":
                newline()
            elif op == b"BI":
                # inline image: tokenise the parameter dict up to ID, then
                # raw-skip the binary payload to the EI marker — otherwise
                # a '(' byte in the pixel data opens a phantom string that
                # swallows real text operators
                while True:
                    t = lex.next_token()
                    if t is None or t == ("kw", b"ID"):
                        break
                m = re.compile(
                    rb"[\x00\t\n\x0c\r ]EI(?![0-9A-Za-z])"
                ).search(lex.data, lex.pos)
                lex.pos = len(lex.data) if m is None else m.end()
            elif op == b"Do" and stack and stack[-1][0] == "name" and depth < 8:
                # Form XObjects wrap whole pages in print pipelines —
                # recurse with the form's OWN resources (images skip)
                ref = xobjs.get(stack[-1][1])
                if isinstance(ref, tuple) and ref[0] == "ref":
                    xd = doc.resolve(ref)
                    body = doc.streams.get(ref[1])
                    if (isinstance(xd, dict) and body
                            and xd.get("Subtype") == "Form"):
                        run(body, doc.resolve(xd.get("Resources")),
                            depth + 1)
            stack.clear()

    run(doc.content_bytes(page), doc.page_resources(page), 0)
    return lines, line_ys, runs


def _page_text(doc: _Document, page: dict) -> str:
    lines, _, _ = _interpret_page(doc, page)
    return "\n".join(ln.rstrip() for ln in lines).strip("\n")


# ------------------------------------------------------------------ tables
#
# Digital-text financial PDFs position each table cell with its own
# Td/Tm, so cells carry device coordinates even though the builtin parser
# never rasterises anything.  The detector recovers the grid from run
# positions alone (no rules/strokes needed): cluster runs into baseline
# rows, find stretches of consecutive multi-cell rows, cluster their x
# origins into columns.  This replaces docling's TableFormer output
# (reference src/pdf_parsing.py:134-162, 549-651) for the builtin path —
# structure from geometry instead of a layout model.

_ROW_TOL = 2.0      # pts: baselines within this merge into one row
_COL_TOL = 14.0     # pts: x origins within this merge into one column


def _detect_tables(
    runs: List[Tuple[float, float, str]],
    min_rows: int = 2,
    min_cols: int = 2,
) -> List[Dict]:
    """Table grids from positioned runs.

    Returns docling-shaped dicts: ``{"data": {"grid": [[{"text"}..]],
    "num_rows", "num_cols"}, "bbox": {...}, "row_ys": [...]}`` — the
    ``row_ys`` let the caller drop the table's lines from the flowed page
    text (the reference separates table cells from text items the same
    way)."""
    if not runs:
        return []
    # ---- cluster into baseline rows (y desc = top to bottom) ----------
    by_y = sorted(runs, key=lambda r: (-r[1], r[0]))
    rows: List[Dict] = []
    for x, y, text in by_y:
        if not text.strip():
            continue
        if rows and abs(rows[-1]["y"] - y) <= _ROW_TOL:
            rows[-1]["cells"].append((x, text))
        else:
            rows.append({"y": y, "cells": [(x, text)]})
    for row in rows:
        # merge same-origin fragments, order cells left to right
        row["cells"].sort(key=lambda c: c[0])
        merged: List[List] = []
        for x, text in row["cells"]:
            if merged and x - merged[-1][0] <= 1.0:
                merged[-1][1] += text
            else:
                merged.append([x, text])
        row["cells"] = merged

    # ---- maximal stretches of consecutive multi-cell rows -------------
    tables: List[Dict] = []
    i = 0
    while i < len(rows):
        if len(rows[i]["cells"]) < 2:
            i += 1
            continue
        j = i
        while j + 1 < len(rows) and len(rows[j + 1]["cells"]) >= 2:
            j += 1
        region = rows[i:j + 1]
        i = j + 1
        if len(region) < min_rows:
            continue
        # ---- columns: 1-D cluster of x origins over the region --------
        xs = sorted({c[0] for row in region for c in row["cells"]})
        col_starts = [xs[0]]
        for x in xs[1:]:
            if x - col_starts[-1] > _COL_TOL:
                col_starts.append(x)
        if len(col_starts) < min_cols:
            continue

        def col_of(x: float) -> int:
            best, bd = 0, abs(x - col_starts[0])
            for ci, cx in enumerate(col_starts):
                d = abs(x - cx)
                if d < bd:
                    best, bd = ci, d
            return best

        grid = []
        for row in region:
            cells = [""] * len(col_starts)
            for x, text in row["cells"]:
                ci = col_of(x)
                cells[ci] = (cells[ci] + " " + text).strip() if cells[ci] \
                    else text.strip()
            grid.append([{"text": c} for c in cells])
        ys = [row["y"] for row in region]
        tables.append({
            "data": {
                "grid": grid,
                "num_rows": len(grid),
                "num_cols": len(col_starts),
            },
            "bbox": {"l": xs[0], "t": max(ys) + _ROW_TOL,
                     "r": xs[-1], "b": min(ys) - _ROW_TOL},
            "row_ys": ys,
        })
    return tables


def _page_structured(doc: _Document, page: dict) -> Dict:
    lines, line_ys, runs = _interpret_page(doc, page)
    tables = _detect_tables(runs)
    table_ys = set()
    for t in tables:
        table_ys.update(t["row_ys"])

    def in_table(y: Optional[float]) -> bool:
        return y is not None and any(abs(y - ty) <= _ROW_TOL
                                     for ty in table_ys)

    kept = [ln.rstrip() for ln, y in zip(lines, line_ys) if not in_table(y)]
    return {
        "text": "\n".join(kept).strip("\n"),
        "tables": tables,
    }


def extract_pdf_pages(data: bytes) -> List[str]:
    """Page texts of a digital-text PDF (see module docstring for scope).

    Raises ``ValueError`` for encrypted files — their strings/streams are
    ciphertext and would extract as garbage; callers should fall back to a
    capable parser (docling) or surface the file to the user."""
    doc = _Document(data)
    if doc.encrypted:
        raise ValueError("encrypted PDF: built-in extraction would emit "
                         "ciphertext; parse with docling or decrypt first")
    return [_page_text(doc, p) for p in doc.page_objects()]


def extract_pdf_pages_structured(data: bytes) -> List[Dict]:
    """Per page: ``{"text", "tables"}`` with detected table grids removed
    from the flowed text (they render as markdown downstream —
    ingestion/merging.py splices ``report["tables"]`` back in by id)."""
    doc = _Document(data)
    if doc.encrypted:
        raise ValueError("encrypted PDF: built-in extraction would emit "
                         "ciphertext; parse with docling or decrypt first")
    return [_page_structured(doc, p) for p in doc.page_objects()]
