"""Document tool family: create/edit/convert/merge/extract + pdf ops.

In-process counterparts of the reference's document sidecar servers
(``browser/startDocumentReaderServer.cjs`` 3793 LoC and friends —
SURVEY.md §2.5/L8), which expose edit_document / create_document /
pdf_operation / document_convert / document_merge / document_extract /
open_browser / analyze_image / screenshot_to_code over localhost HTTP.
Here they are hermetic stdlib-only handlers on ToolsService:

- Office formats are handled at the zip+XML level (no binary deps):
  minimal-but-valid .docx/.xlsx/.pptx writers whose output round-trips
  through the matching extractors in ``sidecars.py``/this module.
- PDFs use an in-tree mini writer (uncompressed text objects) and an
  extractor that also inflates FlateDecode streams, so text extraction
  works for our own output and for many simple foreign PDFs.
- open_browser is a fetch-backed page session (no real browser in the
  sandbox); analyze_image parses image headers in-process and routes
  semantic analysis to a pluggable vision callable, which
  screenshot_to_code requires outright (reference: vision sidecar).
"""

from __future__ import annotations

import base64
import csv
import html as _html
import io
import json
import re
import struct
import time
import zipfile
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from .sandbox import Workspace
from .types import ToolUnavailableError

TEXT_SUFFIXES = (".txt", ".md", ".markdown", ".rst", ".log", ".html",
                 ".htm", ".csv", ".json", "")

# vision_fn(image_bytes, prompt) -> str
VisionFn = Callable[[bytes, str], str]


# ---------------------------------------------------------------------------
# Mini-PDF: writer + extractor
# ---------------------------------------------------------------------------

def _pdf_escape(s: str) -> str:
    s = s.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")
    return s.encode("latin-1", errors="replace").decode("latin-1")


def minipdf_write(pages: List[List[str]]) -> bytes:
    """Serialize pages of text lines as a minimal valid PDF-1.4.

    One content stream per page: Helvetica 11pt, 14pt leading, US-Letter.
    Streams are uncompressed so the extractor (and any text tool) can
    read them back.
    """
    if not pages:
        pages = [[""]]
    objs: List[bytes] = []           # 1-indexed PDF objects, in order
    n_pages = len(pages)
    font_num = 3 + 2 * n_pages
    kids = " ".join(f"{3 + 2 * i} 0 R" for i in range(n_pages))
    objs.append(b"<< /Type /Catalog /Pages 2 0 R >>")
    objs.append(f"<< /Type /Pages /Kids [{kids}] /Count {n_pages} >>"
                .encode())
    for i, lines in enumerate(pages):
        page_num, content_num = 3 + 2 * i, 4 + 2 * i
        objs.append(
            f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
            f"/Contents {content_num} 0 R /Resources << /Font "
            f"<< /F1 {font_num} 0 R >> >> >>".encode())
        body = ["BT /F1 11 Tf 14 TL 72 720 Td"]
        for j, line in enumerate(lines):
            if j:
                body.append("T*")
            body.append(f"({_pdf_escape(line)}) Tj")
        body.append("ET")
        stream = "\n".join(body).encode("latin-1", errors="replace")
        objs.append(b"<< /Length " + str(len(stream)).encode()
                    + b" >>\nstream\n" + stream + b"\nendstream")
    objs.append(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>")

    out = io.BytesIO()
    out.write(b"%PDF-1.4\n")
    offsets = [0]
    for i, obj in enumerate(objs, start=1):
        offsets.append(out.tell())
        out.write(f"{i} 0 obj\n".encode() + obj + b"\nendobj\n")
    xref_at = out.tell()
    out.write(f"xref\n0 {len(objs) + 1}\n".encode())
    out.write(b"0000000000 65535 f \n")
    for off in offsets[1:]:
        out.write(f"{off:010d} 00000 n \n".encode())
    out.write(f"trailer\n<< /Size {len(objs) + 1} /Root 1 0 R >>\n"
              f"startxref\n{xref_at}\n%%EOF\n".encode())
    return out.getvalue()


def _pdf_unescape(s: str) -> str:
    return re.sub(r"\\([()\\])", r"\1", s)


def _stream_text(stream: bytes) -> str:
    """Text-show operators (Tj and TJ arrays) from one content stream."""
    try:
        text = stream.decode("latin-1")
    except UnicodeDecodeError:
        return ""
    parts: List[str] = []
    # Walk ops in order so Tj and T* interleave correctly.
    for m in re.finditer(
            r"\(((?:[^()\\]|\\.)*)\)\s*Tj"            # (..) Tj
            r"|\[((?:[^\]\\]|\\.)*)\]\s*TJ"           # [..] TJ
            r"|T\*|\bTd\b|\bTD\b", text):
        if m.group(0) in ("T*",) or m.group(0).endswith(("Td", "TD")):
            parts.append("\n")
        elif m.group(1) is not None:
            parts.append(_pdf_unescape(m.group(1)))
        elif m.group(2) is not None:
            parts.extend(_pdf_unescape(s)
                         for s in re.findall(r"\(((?:[^()\\]|\\.)*)\)",
                                             m.group(2)))
    joined = "".join(parts)
    return re.sub(r"\n{3,}", "\n\n", joined).strip("\n")


def minipdf_extract_pages(data: bytes) -> List[str]:
    """Per-content-stream text; inflates FlateDecode streams when found.

    Works on this module's own output and on simple foreign PDFs whose
    text sits in (possibly deflated) Tj/TJ operators. Raises ValueError
    when no text could be recovered from a real PDF.
    """
    if not data.startswith(b"%PDF"):
        raise ValueError("not a PDF file")
    pages: List[str] = []
    for m in re.finditer(rb"stream\r?\n(.*?)\r?\nendstream", data,
                         flags=re.S):
        raw = m.group(1)
        candidates = [raw]
        try:
            candidates.append(zlib.decompress(raw))
        except zlib.error:
            pass
        text = ""
        for c in candidates:
            text = _stream_text(c)
            if text:
                break
        if text:
            pages.append(text)
    if not pages:
        raise ValueError(
            "no extractable text streams in PDF (image-only or uses "
            "unsupported encodings; reference: documentReader sidecar)")
    return pages


# ---------------------------------------------------------------------------
# Office writers (zip+XML, matching the extractors in sidecars.py)
# ---------------------------------------------------------------------------

def _x(s: str) -> str:
    return _html.escape(str(s), quote=False)


def docx_write(paragraphs: List[str]) -> bytes:
    body = "".join(
        f"<w:p><w:r><w:t xml:space=\"preserve\">{_x(p)}</w:t></w:r></w:p>"
        for p in paragraphs)
    doc = ("<?xml version=\"1.0\" encoding=\"UTF-8\" standalone=\"yes\"?>"
           "<w:document xmlns:w=\"http://schemas.openxmlformats.org/"
           "wordprocessingml/2006/main\"><w:body>"
           f"{body}</w:body></w:document>")
    return _zip({
        "[Content_Types].xml":
            "<?xml version=\"1.0\"?><Types xmlns=\"http://schemas."
            "openxmlformats.org/package/2006/content-types\">"
            "<Default Extension=\"rels\" ContentType=\"application/vnd."
            "openxmlformats-package.relationships+xml\"/>"
            "<Default Extension=\"xml\" ContentType=\"application/xml\"/>"
            "<Override PartName=\"/word/document.xml\" ContentType="
            "\"application/vnd.openxmlformats-officedocument."
            "wordprocessingml.document.main+xml\"/></Types>",
        "_rels/.rels":
            "<?xml version=\"1.0\"?><Relationships xmlns=\"http://schemas."
            "openxmlformats.org/package/2006/relationships\">"
            "<Relationship Id=\"rId1\" Type=\"http://schemas."
            "openxmlformats.org/officeDocument/2006/relationships/"
            "officeDocument\" Target=\"word/document.xml\"/>"
            "</Relationships>",
        "word/document.xml": doc,
    })


def xlsx_write(rows: List[List[Any]]) -> bytes:
    """Shared-strings layout (t="s") so sidecars._xlsx_text reads it back."""
    shared: List[str] = []
    index: Dict[str, int] = {}
    cells_xml: List[str] = []
    for r, row in enumerate(rows, start=1):
        cs = []
        for c, val in enumerate(row):
            col = ""
            n = c
            while True:
                col = chr(ord("A") + n % 26) + col
                n = n // 26 - 1
                if n < 0:
                    break
            ref = f"{col}{r}"
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                cs.append(f"<c r=\"{ref}\"><v>{val}</v></c>")
            else:
                s = str(val)
                if s not in index:
                    index[s] = len(shared)
                    shared.append(s)
                cs.append(f"<c r=\"{ref}\" t=\"s\"><v>{index[s]}</v></c>")
        cells_xml.append(f"<row r=\"{r}\">{''.join(cs)}</row>")
    sheet = ("<?xml version=\"1.0\"?><worksheet xmlns=\"http://schemas."
             "openxmlformats.org/spreadsheetml/2006/main\"><sheetData>"
             f"{''.join(cells_xml)}</sheetData></worksheet>")
    sst = ("<?xml version=\"1.0\"?><sst xmlns=\"http://schemas."
           "openxmlformats.org/spreadsheetml/2006/main\" count="
           f"\"{len(shared)}\" uniqueCount=\"{len(shared)}\">"
           + "".join(f"<si><t xml:space=\"preserve\">{_x(s)}</t></si>"
                     for s in shared) + "</sst>")
    wb = ("<?xml version=\"1.0\"?><workbook xmlns=\"http://schemas."
          "openxmlformats.org/spreadsheetml/2006/main\" xmlns:r=\"http://"
          "schemas.openxmlformats.org/officeDocument/2006/relationships\">"
          "<sheets><sheet name=\"Sheet1\" sheetId=\"1\" r:id=\"rId1\"/>"
          "</sheets></workbook>")
    return _zip({
        "[Content_Types].xml":
            "<?xml version=\"1.0\"?><Types xmlns=\"http://schemas."
            "openxmlformats.org/package/2006/content-types\">"
            "<Default Extension=\"rels\" ContentType=\"application/vnd."
            "openxmlformats-package.relationships+xml\"/>"
            "<Default Extension=\"xml\" ContentType=\"application/xml\"/>"
            "<Override PartName=\"/xl/workbook.xml\" ContentType="
            "\"application/vnd.openxmlformats-officedocument."
            "spreadsheetml.sheet.main+xml\"/>"
            "<Override PartName=\"/xl/worksheets/sheet1.xml\" ContentType="
            "\"application/vnd.openxmlformats-officedocument."
            "spreadsheetml.worksheet+xml\"/>"
            "<Override PartName=\"/xl/sharedStrings.xml\" ContentType="
            "\"application/vnd.openxmlformats-officedocument."
            "spreadsheetml.sharedStrings+xml\"/></Types>",
        "_rels/.rels":
            "<?xml version=\"1.0\"?><Relationships xmlns=\"http://schemas."
            "openxmlformats.org/package/2006/relationships\">"
            "<Relationship Id=\"rId1\" Type=\"http://schemas."
            "openxmlformats.org/officeDocument/2006/relationships/"
            "officeDocument\" Target=\"xl/workbook.xml\"/></Relationships>",
        "xl/_rels/workbook.xml.rels":
            "<?xml version=\"1.0\"?><Relationships xmlns=\"http://schemas."
            "openxmlformats.org/package/2006/relationships\">"
            "<Relationship Id=\"rId1\" Type=\"http://schemas."
            "openxmlformats.org/officeDocument/2006/relationships/"
            "worksheet\" Target=\"worksheets/sheet1.xml\"/>"
            "<Relationship Id=\"rId2\" Type=\"http://schemas."
            "openxmlformats.org/officeDocument/2006/relationships/"
            "sharedStrings\" Target=\"sharedStrings.xml\"/>"
            "</Relationships>",
        "xl/workbook.xml": wb,
        "xl/sharedStrings.xml": sst,
        "xl/worksheets/sheet1.xml": sheet,
    })


def pptx_write(slides: List[Dict[str, Any]]) -> bytes:
    """Slides as {"title": str, "content": [str]}. Minimal single-master
    deck; text round-trips via :func:`pptx_text`."""
    files: Dict[str, str] = {}
    n = len(slides) or 1
    slide_overrides = "".join(
        f"<Override PartName=\"/ppt/slides/slide{i}.xml\" ContentType="
        "\"application/vnd.openxmlformats-officedocument.presentationml."
        "slide+xml\"/>" for i in range(1, n + 1))
    files["[Content_Types].xml"] = (
        "<?xml version=\"1.0\"?><Types xmlns=\"http://schemas."
        "openxmlformats.org/package/2006/content-types\">"
        "<Default Extension=\"rels\" ContentType=\"application/vnd."
        "openxmlformats-package.relationships+xml\"/>"
        "<Default Extension=\"xml\" ContentType=\"application/xml\"/>"
        "<Override PartName=\"/ppt/presentation.xml\" ContentType="
        "\"application/vnd.openxmlformats-officedocument.presentationml."
        "presentation.main+xml\"/>" + slide_overrides + "</Types>")
    files["_rels/.rels"] = (
        "<?xml version=\"1.0\"?><Relationships xmlns=\"http://schemas."
        "openxmlformats.org/package/2006/relationships\">"
        "<Relationship Id=\"rId1\" Type=\"http://schemas.openxmlformats."
        "org/officeDocument/2006/relationships/officeDocument\" "
        "Target=\"ppt/presentation.xml\"/></Relationships>")
    sld_ids = "".join(
        f"<p:sldId id=\"{255 + i}\" r:id=\"rId{i}\"/>"
        for i in range(1, n + 1))
    files["ppt/presentation.xml"] = (
        "<?xml version=\"1.0\"?><p:presentation xmlns:p=\"http://schemas."
        "openxmlformats.org/presentationml/2006/main\" xmlns:r=\"http://"
        "schemas.openxmlformats.org/officeDocument/2006/relationships\">"
        f"<p:sldIdLst>{sld_ids}</p:sldIdLst></p:presentation>")
    files["ppt/_rels/presentation.xml.rels"] = (
        "<?xml version=\"1.0\"?><Relationships xmlns=\"http://schemas."
        "openxmlformats.org/package/2006/relationships\">"
        + "".join(
            f"<Relationship Id=\"rId{i}\" Type=\"http://schemas."
            "openxmlformats.org/officeDocument/2006/relationships/slide\" "
            f"Target=\"slides/slide{i}.xml\"/>"
            for i in range(1, n + 1)) + "</Relationships>")
    for i, slide in enumerate(slides or [{}], start=1):
        paras = [slide.get("title", "")] + list(slide.get("content", []))
        body = "".join(
            "<a:p><a:r><a:t>" + _x(t) + "</a:t></a:r></a:p>"
            for t in paras if t != "")
        files[f"ppt/slides/slide{i}.xml"] = (
            "<?xml version=\"1.0\"?><p:sld xmlns:p=\"http://schemas."
            "openxmlformats.org/presentationml/2006/main\" xmlns:a="
            "\"http://schemas.openxmlformats.org/drawingml/2006/main\">"
            "<p:cSld><p:spTree><p:sp><p:txBody>" + body +
            "</p:txBody></p:sp></p:spTree></p:cSld></p:sld>")
    return _zip(files)


def pptx_text(path) -> str:
    """Slide text (a:t runs), one line per paragraph, slides separated by
    a blank line."""
    with zipfile.ZipFile(path) as z:
        names = sorted(
            (n for n in z.namelist()
             if re.match(r"ppt/slides/slide\d+\.xml$", n)),
            key=lambda n: int(re.search(r"(\d+)", n).group(1)))
        out: List[str] = []
        for name in names:
            xml = z.read(name).decode(errors="replace")
            paras = []
            for p in re.findall(r"(?s)<a:p[ >].*?</a:p>|<a:p/>", xml):
                runs = re.findall(r"<a:t[^>]*>(.*?)</a:t>", p, flags=re.S)
                if runs:
                    paras.append(_html.unescape("".join(runs)))
            out.append("\n".join(paras))
    return "\n\n".join(out)


def _zip(files: Dict[str, str]) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for name, content in files.items():
            z.writestr(name, content)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# Image header parsing (analyze_image's in-process half)
# ---------------------------------------------------------------------------

def image_info(data: bytes) -> Dict[str, Any]:
    """Format + dimensions from magic bytes (PNG/JPEG/GIF/BMP/WEBP)."""
    if data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) >= 24:
        w, h = struct.unpack(">II", data[16:24])
        return {"format": "png", "width": w, "height": h}
    if data[:2] == b"\xff\xd8":
        i = 2
        while i + 9 < len(data):
            if data[i] != 0xFF:
                i += 1
                continue
            marker = data[i + 1]
            if marker in (0xC0, 0xC1, 0xC2, 0xC3):   # SOFn
                h, w = struct.unpack(">HH", data[i + 5:i + 9])
                return {"format": "jpeg", "width": w, "height": h}
            seg_len = struct.unpack(">H", data[i + 2:i + 4])[0]
            i += 2 + seg_len
        return {"format": "jpeg", "width": None, "height": None}
    if data[:6] in (b"GIF87a", b"GIF89a") and len(data) >= 10:
        w, h = struct.unpack("<HH", data[6:10])
        return {"format": "gif", "width": w, "height": h}
    if data[:2] == b"BM" and len(data) >= 26:
        w, h = struct.unpack("<ii", data[18:26])
        return {"format": "bmp", "width": w, "height": abs(h)}
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return {"format": "webp", "width": None, "height": None}
    raise ValueError("unrecognized image format")


# ---------------------------------------------------------------------------
# The tool service
# ---------------------------------------------------------------------------

class DocumentServices:
    """Handlers for the document/browser/vision tool families."""

    def __init__(self, workspace: Workspace, *,
                 vision_fn: Optional[VisionFn] = None,
                 fetch_fn: Optional[Callable[[str], Tuple[str, str]]] = None,
                 sidecars=None, max_content: int = 50_000):
        self.workspace = workspace
        self.vision_fn = vision_fn
        self._fetch_fn = fetch_fn
        # Network access rides the sidecar layer so SidecarConfig's
        # url_filter / timeout / byte caps govern open_browser too —
        # one fetch path, one policy (review finding: no second
        # unrestricted urllib path out of the rollout sandbox).
        from .sidecars import SidecarServices
        self.sidecars = sidecars or SidecarServices(workspace)
        self.max_content = max_content
        self._browser_sessions: Dict[str, Dict[str, Any]] = {}
        self._next_session = 1

    def install(self, tools) -> None:
        for name in ("edit_document", "create_document", "pdf_operation",
                     "document_convert", "document_merge",
                     "document_extract", "open_browser", "analyze_image",
                     "screenshot_to_code"):
            tools.register_handler(name, getattr(self, name))

    def mutation_targets(self, tool: str, p: Dict[str, Any]) -> List[str]:
        """Paths a document tool will (over)write, BEFORE execution —
        the before-edit snapshot hook's source of truth. Lives here so it
        can mirror each handler's real path arithmetic (split writes
        ``{stem}_page{i}.pdf``, convert honors the ``format`` override)
        instead of a second hand-rolled guess drifting in the session."""
        if tool in ("edit_document",):
            return [p["uri"]] if p.get("uri") else []
        if tool == "create_document":
            return [p["file_path"]] if p.get("file_path") else []
        if tool in ("document_merge",):
            return [p["output_path"]] if p.get("output_path") else []
        if tool == "document_convert":
            out = p.get("output_path")
            if not out:
                return []
            fmt = (p.get("format")
                   or Path(out).suffix.lstrip(".")).lower()
            dst = self.workspace.resolve(out)
            if fmt and dst.suffix.lstrip(".").lower() != fmt:
                dst = dst.with_suffix("." + fmt)
            return [str(dst.relative_to(self.workspace.root))]
        if tool == "pdf_operation":
            out = p.get("output_path")
            if not out:
                return []
            if str(p.get("operation", "")).lower() == "split":
                stem = self.workspace.resolve(out)
                return [str(f.relative_to(self.workspace.root))
                        for f in sorted(
                            stem.parent.glob(f"{stem.stem}_page*.pdf"))]
            return [out]
        return []

    # -- reading any supported format --------------------------------------
    def read_text_any(self, path: Path) -> str:
        """Plain-text view of any supported document format."""
        suffix = path.suffix.lower()
        if suffix == ".pdf":
            return "\n\n".join(minipdf_extract_pages(path.read_bytes()))
        if suffix == ".pptx":
            return pptx_text(path)
        if suffix == ".docx":
            from .sidecars import SidecarServices
            return SidecarServices._docx_text(path)
        if suffix == ".xlsx":
            from .sidecars import SidecarServices
            return SidecarServices._xlsx_text(path)
        if suffix in (".html", ".htm"):
            from .sidecars import html_to_text
            return html_to_text(path.read_text(errors="replace"))
        return path.read_text(errors="replace")

    def _write_as(self, path: Path, text: str) -> None:
        """Write plain text into the format implied by ``path``'s suffix."""
        suffix = path.suffix.lower()
        lines = text.split("\n")
        if suffix == ".docx":
            data: bytes = docx_write(lines)
        elif suffix == ".xlsx":
            rows = [self._split_row(ln) for ln in lines if ln.strip()]
            data = xlsx_write(rows)
        elif suffix == ".pptx":
            slides = [{"title": chunk[0] if chunk else "",
                       "content": chunk[1:]}
                      for chunk in _chunk_blank(lines)]
            data = pptx_write(slides)
        elif suffix == ".pdf":
            pages = [lines[i:i + 48] for i in range(0, len(lines), 48)]
            data = minipdf_write(pages or [[""]])
        elif suffix == ".csv":
            out = io.StringIO()
            w = csv.writer(out)
            for ln in lines:
                w.writerow(self._split_row(ln))
            path.write_text(out.getvalue())
            return
        elif suffix in (".html", ".htm"):
            body = "".join(f"<p>{_x(ln)}</p>\n" for ln in lines if ln)
            path.write_text("<!DOCTYPE html>\n<html><body>\n"
                            f"{body}</body></html>\n")
            return
        else:
            path.write_text(text)
            return
        path.write_bytes(data)

    @staticmethod
    def _structured(v: Any) -> Any:
        """Tool params travel as strings in the XML call grammar; decode
        JSON-shaped payloads (objects/arrays) back into structure."""
        if isinstance(v, str):
            s = v.strip()
            if s[:1] in ("{", "["):
                try:
                    return json.loads(s)
                except json.JSONDecodeError:
                    return v
        return v

    @staticmethod
    def _split_row(line: str) -> List[str]:
        if "\t" in line:
            return line.split("\t")
        if "," in line:
            return next(csv.reader(io.StringIO(line)))
        return [line]

    # -- edit_document -----------------------------------------------------
    def edit_document(self, p: Dict[str, Any]) -> Dict[str, Any]:
        path = self.workspace.resolve(p["uri"])
        if not path.is_file():
            raise FileNotFoundError(f"document does not exist: {p['uri']}")
        text = self.read_text_any(path)
        changes = 0
        if p.get("content") is not None:
            text = str(p["content"])
            changes = 1
        for rep in (self._structured(p.get("replacements")) or []):
            if isinstance(rep, dict):
                find, replace = rep.get("find", ""), rep.get("replace", "")
            else:
                find, replace = rep[0], rep[1]
            if find and find in text:
                text = text.replace(find, replace)
                changes += 1
        self._write_as(path, text)
        return {"uri": p["uri"], "format": path.suffix.lower() or "text",
                "changes": changes, "total_length": len(text)}

    # -- create_document ---------------------------------------------------
    def create_document(self, p: Dict[str, Any]) -> Dict[str, Any]:
        dtype = str(p["type"]).lower()
        path = self.workspace.resolve(p["file_path"])
        data = self._structured(p["document_data"])
        path.parent.mkdir(parents=True, exist_ok=True)

        def field(key: str) -> Any:
            # A dict payload must carry the type-specific key; anything
            # else is an actionable schema error, not a TypeError.
            v = data.get(key)
            if v is None:
                raise ValueError(
                    f"document_data for type '{dtype}' must contain "
                    f"'{key}' (got keys: {sorted(data.keys())})")
            return v

        if dtype in ("word", "docx"):
            paras = (field("paragraphs") if isinstance(data, dict)
                     else str(data).split("\n"))
            path.write_bytes(docx_write([str(x) for x in paras]))
        elif dtype in ("excel", "xlsx"):
            rows = (field("rows") if isinstance(data, dict)
                    else [self._split_row(ln)
                          for ln in str(data).split("\n") if ln.strip()])
            path.write_bytes(xlsx_write(rows))
        elif dtype in ("ppt", "pptx"):
            slides = (field("slides") if isinstance(data, dict)
                      else [{"title": s[0] if s else "", "content": s[1:]}
                            for s in _chunk_blank(str(data).split("\n"))])
            path.write_bytes(pptx_write(list(slides)))
        elif dtype == "pdf":
            lines = (field("lines") if isinstance(data, dict)
                     else str(data).split("\n"))
            pages = [lines[i:i + 48] for i in range(0, len(lines), 48)]
            path.write_bytes(minipdf_write(pages or [[""]]))
        else:
            raise ValueError(f"unsupported document type: {dtype}")
        return {"created": p["file_path"], "type": dtype,
                "bytes": path.stat().st_size}

    # -- pdf_operation -----------------------------------------------------
    def pdf_operation(self, p: Dict[str, Any]) -> Dict[str, Any]:
        op = str(p["operation"]).lower()
        inputs = self._structured(p.get("input_files")) or []
        if isinstance(inputs, str):
            inputs = [inputs]
        if not inputs:
            raise ValueError("pdf_operation needs input_files")
        paths = [self.workspace.resolve(u) for u in inputs]
        if op == "merge":
            pages: List[str] = []
            for path in paths:
                pages.extend(minipdf_extract_pages(path.read_bytes()))
            out = self.workspace.resolve(p["output_path"])
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_bytes(minipdf_write([pg.split("\n") for pg in pages]))
            return {"operation": op, "output": p["output_path"],
                    "pages": len(pages)}
        if op == "split":
            pages = minipdf_extract_pages(paths[0].read_bytes())
            stem = self.workspace.resolve(p["output_path"])
            stem.parent.mkdir(parents=True, exist_ok=True)
            created = []
            for i, pg in enumerate(pages, start=1):
                target = stem.parent / f"{stem.stem}_page{i}.pdf"
                target.write_bytes(minipdf_write([pg.split("\n")]))
                created.append(target.name)
            return {"operation": op, "created": created,
                    "pages": len(pages)}
        if op == "watermark":
            mark = str(p.get("watermark_text") or p.get("text") or "DRAFT")
            pages = minipdf_extract_pages(paths[0].read_bytes())
            out = self.workspace.resolve(p["output_path"])
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_bytes(minipdf_write(
                [[f"[{mark}]"] + pg.split("\n") for pg in pages]))
            return {"operation": op, "output": p["output_path"],
                    "watermark": mark, "pages": len(pages)}
        raise ValueError(f"unknown pdf operation: {op}")

    # -- document_convert / merge / extract --------------------------------
    def document_convert(self, p: Dict[str, Any]) -> Dict[str, Any]:
        src = self.workspace.resolve(p["input_file"])
        if not src.is_file():
            raise FileNotFoundError(f"no such document: {p['input_file']}")
        dst = self.workspace.resolve(p["output_path"])
        fmt = (p.get("format") or dst.suffix.lstrip(".")).lower()
        if fmt and dst.suffix.lstrip(".").lower() != fmt:
            dst = dst.with_suffix("." + fmt)
        text = self.read_text_any(src)
        dst.parent.mkdir(parents=True, exist_ok=True)
        self._write_as(dst, text)
        return {"input": p["input_file"], "output": dst.name,
                "format": fmt or "text", "chars": len(text)}

    def document_merge(self, p: Dict[str, Any]) -> Dict[str, Any]:
        inputs = self._structured(p["input_files"])
        if isinstance(inputs, str):
            inputs = [s for s in re.split(r"[,\n]", inputs) if s.strip()]
        texts = []
        for uri in inputs:
            path = self.workspace.resolve(uri.strip())
            texts.append(self.read_text_any(path))
        merged = "\n\n".join(texts)
        dst = self.workspace.resolve(p["output_path"])
        dst.parent.mkdir(parents=True, exist_ok=True)
        self._write_as(dst, merged)
        return {"output": p["output_path"], "inputs": len(texts),
                "chars": len(merged)}

    def document_extract(self, p: Dict[str, Any]) -> Dict[str, Any]:
        path = self.workspace.resolve(p["input_file"])
        if not path.is_file():
            raise FileNotFoundError(f"no such document: {p['input_file']}")
        kind = str(p.get("extract_type") or "text").lower()
        text = self.read_text_any(path)
        if kind == "text":
            return {"extract_type": kind,
                    "content": text[: self.max_content],
                    "truncated": len(text) > self.max_content}
        if kind == "links":
            links = re.findall(r"https?://[^\s)\"'<>\]]+", text)
            return {"extract_type": kind, "links": links[:500]}
        if kind == "emails":
            emails = sorted(set(re.findall(
                r"[A-Za-z0-9._%+-]+@[A-Za-z0-9.-]+\.[A-Za-z]{2,}", text)))
            return {"extract_type": kind, "emails": emails[:500]}
        if kind == "tables":
            rows = [ln for ln in text.split("\n")
                    if "\t" in ln or ln.lstrip().startswith("|")]
            return {"extract_type": kind,
                    "rows": [self._split_row(ln.strip().strip("|"))
                             if "\t" in ln else
                             [c.strip() for c in ln.strip().strip("|")
                              .split("|")]
                             for ln in rows[:500]]}
        if kind == "metadata":
            return {"extract_type": kind,
                    "format": path.suffix.lower() or "text",
                    "bytes": path.stat().st_size, "chars": len(text),
                    "lines": text.count("\n") + 1,
                    "words": len(text.split())}
        raise ValueError(f"unknown extract_type: {kind}")

    # -- open_browser ------------------------------------------------------
    def open_browser(self, p: Dict[str, Any]) -> Dict[str, Any]:
        """Fetch-backed page session: the sandbox has no display, so the
        'browser' is a readable-text view plus the page's links (the
        reference drives a real browser via startOpenBrowserServer.cjs)."""
        from .sidecars import html_to_text, _title_of
        url = p["url"]
        if self._fetch_fn is not None:
            markup, final_url = self._fetch_fn(url)
        else:
            self.sidecars._check_url(url)
            markup, _ctype, final_url = self.sidecars._get(url)
        links = re.findall(r"(?i)<a[^>]+href=[\"']([^\"'#][^\"']*)[\"']",
                           markup)[:100]
        session_id = f"browser-{self._next_session}"
        self._next_session += 1
        self._browser_sessions[session_id] = {
            "url": final_url, "opened_at": time.time()}
        return {"session_id": session_id, "url": final_url,
                "title": _title_of(markup),
                "content": html_to_text(markup)[: self.max_content],
                "links": links}

    # -- vision tools ------------------------------------------------------
    def analyze_image(self, p: Dict[str, Any]) -> Dict[str, Any]:
        data = base64.b64decode(p["image_data"], validate=False)
        info = image_info(data)
        info["bytes"] = len(data)
        prompt = str(p.get("prompt") or "Describe this image.")
        if self.vision_fn is not None:
            info["analysis"] = self.vision_fn(data, prompt)
        else:
            info["note"] = ("no vision model configured; returning image "
                            "metadata only")
        return info

    def screenshot_to_code(self, p: Dict[str, Any]) -> Dict[str, Any]:
        if self.vision_fn is None:
            raise ToolUnavailableError(
                "screenshot_to_code needs a vision-capable model "
                "(DocumentServices(vision_fn=...); reference: "
                "startScreenshotToCodeServer.cjs)")
        source = str(p["source"]).lower()
        stack = str(p.get("stack") or "html")
        if source == "image":
            data = base64.b64decode(p["image_data"], validate=False)
        elif source == "url":
            shot = self.open_browser({"url": p["url"]})
            data = shot["content"].encode()
        else:
            raise ValueError("source must be 'image' or 'url'")
        code = self.vision_fn(
            data, f"Generate {stack} code reproducing this UI. "
                  f"Return only code.")
        return {"stack": stack, "code": code}


def _chunk_blank(lines: List[str]) -> List[List[str]]:
    """Split lines into blank-line-separated chunks (≥1 chunk)."""
    chunks: List[List[str]] = [[]]
    for ln in lines:
        if ln.strip() == "":
            if chunks[-1]:
                chunks.append([])
        else:
            chunks[-1].append(ln)
    if not chunks[-1]:
        chunks.pop()
    return chunks or [[]]
