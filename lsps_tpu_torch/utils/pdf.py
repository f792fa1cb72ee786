"""A minimal PDF 1.4 writer for the evaluation plots (no matplotlib).

One page, drawn with a handful of operators: polylines, filled and
outlined rectangles, stroke and fill colours in RGB, line width, a clip
rectangle, and text in the base-14 Helvetica font (which a reader carries,
so nothing is embedded).  The content stream is uncompressed, so a test
can read the drawn coordinates back: a path given in ``data`` units is
written under a translation only, its coordinates multiplied by the
caller's scale (a power of two, so the product is exact) and printed as
the shortest decimal that reads back to the same float64.

    page = PDFPage(width, height)
    page.polyline([(x0, y0), (x1, y1)], color=(0, 0, 1), width=1.5)
    page.text(10, 10, "label", size=10)
    page.save("plot.pdf")
"""

from __future__ import annotations

import os
from typing import Iterable, List, Sequence, Tuple

import numpy as np

# Helvetica's advance widths (its AFM, 1/1000 em) for ASCII 32-126
_HELVETICA = (
    278, 278, 355, 556, 556, 889, 667, 191, 333, 333, 389, 584, 278, 333,
    278, 278, 556, 556, 556, 556, 556, 556, 556, 556, 556, 556, 278, 278,
    584, 584, 584, 556, 1015, 667, 667, 722, 722, 667, 611, 778, 722, 278,
    500, 667, 556, 833, 722, 778, 667, 778, 722, 667, 611, 722, 667, 944,
    667, 667, 611, 278, 278, 278, 469, 556, 333, 556, 556, 500, 556, 556,
    278, 556, 556, 222, 222, 500, 222, 833, 556, 556, 556, 556, 333, 500,
    278, 556, 500, 722, 500, 500, 500, 334, 260, 334, 584)


def text_width(s: str, size: float) -> float:
    """The width of ``s`` in Helvetica at ``size`` points."""
    return sum(_HELVETICA[ord(c) - 32] if 32 <= ord(c) <= 126 else 556
               for c in s) * size / 1000.0


def num(v: float) -> str:
    """A PDF number: the shortest decimal that reads back as ``v``
    (float64), with no exponent."""
    v = float(v)
    if not np.isfinite(v):
        raise ValueError(f"a PDF number cannot be {v}")
    s = np.format_float_positional(v, unique=True, trim="-")
    return "0" if s in ("-0", "0") else s


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")


def _rgb(color: Sequence[float]) -> str:
    return " ".join(num(c) for c in color[:3])


class PDFPage:
    """A one-page PDF of ``width`` x ``height`` points."""

    def __init__(self, width: float, height: float):
        self.width, self.height = float(width), float(height)
        self.ops: List[str] = []

    # -- state --------------------------------------------------------------
    def save_state(self) -> None:
        self.ops.append("q")

    def restore_state(self) -> None:
        self.ops.append("Q")

    def clip_rect(self, x: float, y: float, w: float, h: float) -> None:
        """Clip what follows (until ``restore_state``) to a rectangle."""
        self.ops.append(f"{num(x)} {num(y)} {num(w)} {num(h)} re W n")

    def translate(self, x: float, y: float) -> None:
        self.ops.append(f"1 0 0 1 {num(x)} {num(y)} cm")

    # -- painting -----------------------------------------------------------
    def polyline(self, pts: Iterable[Tuple[float, float]], color=(0, 0, 0),
                 width: float = 1.0) -> None:
        """An open path through ``pts``, stroked with round caps and
        joins."""
        pts = list(pts)
        if len(pts) < 2:
            return
        path = [f"{num(pts[0][0])} {num(pts[0][1])} m"]
        path += [f"{num(x)} {num(y)} l" for x, y in pts[1:]]
        self.ops.append(f"{_rgb(color)} RG {num(width)} w [] 0 d 1 J 1 j\n"
                        + "\n".join(path) + "\nS")

    def rect(self, x: float, y: float, w: float, h: float,
             fill=None, stroke=None, width: float = 1.0) -> None:
        """A rectangle, filled with ``fill`` and/or outlined in
        ``stroke``."""
        op = {(True, True): "B", (True, False): "f",
              (False, True): "S"}.get((fill is not None, stroke is not None))
        if op is None:
            return
        head = ""
        if fill is not None:
            head += f"{_rgb(fill)} rg "
        if stroke is not None:
            head += f"{_rgb(stroke)} RG {num(width)} w [] 0 d "
        self.ops.append(f"{head}{num(x)} {num(y)} {num(w)} {num(h)} re "
                        f"{op}")

    def text(self, x: float, y: float, s: str, size: float = 10.0,
             color=(0, 0, 0), anchor: str = "left", rotate: int = 0) -> None:
        """``s`` in Helvetica with its baseline's ``anchor`` point
        (``left``, ``center`` or ``right``) at (x, y), rotated by 0 or 90
        degrees counter-clockwise."""
        w = text_width(s, size)
        shift = {"left": 0.0, "center": w / 2, "right": w}[anchor]
        if rotate == 90:
            m = f"0 1 -1 0 {num(x)} {num(y - shift)}"
        elif rotate == 0:
            m = f"1 0 0 1 {num(x - shift)} {num(y)}"
        else:
            raise ValueError("text turns by 0 or 90 degrees")
        self.ops.append(f"BT {_rgb(color)} rg /F1 {num(size)} Tf {m} Tm "
                        f"({_escape(s)}) Tj ET")

    # -- file ---------------------------------------------------------------
    def to_bytes(self) -> bytes:
        content = ("\n".join(self.ops) + "\n").encode("latin-1")
        objs = [
            b"<< /Type /Catalog /Pages 2 0 R >>",
            b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
            (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 "
             f"{num(self.width)} {num(self.height)}] /Resources << /Font "
             f"<< /F1 5 0 R >> >> /Contents 4 0 R >>").encode(),
            b"<< /Length " + str(len(content)).encode() + b" >>\nstream\n"
            + content + b"endstream",
            b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica "
            b"/Encoding /WinAnsiEncoding >>",
        ]
        out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = []
        for i, body in enumerate(objs, 1):
            offsets.append(len(out))
            out += f"{i} 0 obj\n".encode() + body + b"\nendobj\n"
        xref = len(out)
        out += f"xref\n0 {len(objs) + 1}\n".encode()
        out += b"0000000000 65535 f \n"
        for off in offsets:
            out += f"{off:010d} 00000 n \n".encode()
        out += (f"trailer\n<< /Size {len(objs) + 1} /Root 1 0 R >>\n"
                f"startxref\n{xref}\n%%EOF\n").encode()
        return bytes(out)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(self.to_bytes())


def check_pdf(data: bytes) -> int:
    """Check a file of this writer's form: the header, every xref entry
    pointing at its ``n 0 obj``, ``startxref`` at the xref and the
    ``%%EOF`` trailer; returns the number of objects.  Raises
    ``ValueError`` naming what is wrong."""
    if not data.startswith(b"%PDF-1."):
        raise ValueError("no %PDF header")
    if not data.rstrip().endswith(b"%%EOF"):
        raise ValueError("no %%EOF")
    tail = data[data.rindex(b"startxref"):].split()
    xref = int(tail[1])
    if data[xref:xref + 4] != b"xref":
        raise ValueError("startxref does not point at the xref")
    lines = data[xref:].split(b"\n")
    first, count = (int(v) for v in lines[1].split())
    for k in range(1, count):
        entry = lines[2 + k].split()
        off = int(entry[0])
        want = f"{first + k} 0 obj".encode()
        if entry[2] != b"n" or data[off:off + len(want)] != want:
            raise ValueError(f"xref entry {first + k} points at "
                             f"{data[off:off + 12]!r}")
    return count - 1
