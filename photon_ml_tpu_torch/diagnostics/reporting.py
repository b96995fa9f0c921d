"""Logical report tree -> HTML and text rendering, stdlib only (port of
``photon_ml_tpu/diagnostics/reporting.py``, host Python copied as it is).

Reference: photon-ml .../diagnostics/reporting/** — logical reports
(document/chapter/section with text, tables, plots) transformed to a
physical report and rendered by a strategy (html/HTMLRenderStrategy.scala
:1-73 uses scala.xml + xchart/batik rasterized plots). Here plots are
hand-rolled inline SVG (no plotting dependency in the image).
"""

from __future__ import annotations

import html
import os
from dataclasses import dataclass, field
from typing import List, Tuple, Union


@dataclass
class Text:
    body: str


@dataclass
class Table:
    header: List[str]
    rows: List[List[str]]
    caption: str = ""


@dataclass
class LinePlot:
    """Simple multi-series line plot rendered as inline SVG."""

    x: List[float]
    series: List[Tuple[str, List[float]]]
    title: str = ""
    x_label: str = ""
    y_label: str = ""


@dataclass
class Section:
    title: str
    items: List[Union[Text, Table, LinePlot]] = field(default_factory=list)


@dataclass
class Chapter:
    title: str
    sections: List[Section] = field(default_factory=list)


@dataclass
class Document:
    title: str
    chapters: List[Chapter] = field(default_factory=list)


_PALETTE = ["#3366cc", "#dc3912", "#ff9900", "#109618", "#990099"]


def _svg_line_plot(plot: LinePlot, width: int = 560, height: int = 320) -> str:
    pad = 48
    xs = list(plot.x)
    all_y = [y for _, ys in plot.series for y in ys if y == y]
    if not xs or not all_y:
        return "<p>(empty plot)</p>"
    x_min, x_max = min(xs), max(xs)
    y_min, y_max = min(all_y), max(all_y)
    if x_max == x_min:
        x_max = x_min + 1.0
    if y_max == y_min:
        y_max = y_min + 1.0

    def sx(v):
        return pad + (v - x_min) / (x_max - x_min) * (width - 2 * pad)

    def sy(v):
        return height - pad - (v - y_min) / (y_max - y_min) * (height - 2 * pad)

    parts = [
        f'<svg width="{width}" height="{height}" '
        'xmlns="http://www.w3.org/2000/svg" style="background:#fff">'
    ]
    if plot.title:
        parts.append(
            f'<text x="{width/2}" y="18" text-anchor="middle" '
            f'font-size="14">{html.escape(plot.title)}</text>'
        )
    # axes
    parts.append(
        f'<line x1="{pad}" y1="{height-pad}" x2="{width-pad}" '
        f'y2="{height-pad}" stroke="#333"/>'
    )
    parts.append(
        f'<line x1="{pad}" y1="{pad}" x2="{pad}" y2="{height-pad}" stroke="#333"/>'
    )
    for frac in (0.0, 0.5, 1.0):
        xv = x_min + frac * (x_max - x_min)
        yv = y_min + frac * (y_max - y_min)
        parts.append(
            f'<text x="{sx(xv)}" y="{height-pad+16}" text-anchor="middle" '
            f'font-size="10">{xv:.3g}</text>'
        )
        parts.append(
            f'<text x="{pad-6}" y="{sy(yv)+4}" text-anchor="end" '
            f'font-size="10">{yv:.3g}</text>'
        )
    if plot.x_label:
        parts.append(
            f'<text x="{width/2}" y="{height-8}" text-anchor="middle" '
            f'font-size="11">{html.escape(plot.x_label)}</text>'
        )
    if plot.y_label:
        parts.append(
            f'<text x="14" y="{height/2}" text-anchor="middle" font-size="11" '
            f'transform="rotate(-90 14 {height/2})">{html.escape(plot.y_label)}</text>'
        )
    for si, (name, ys) in enumerate(plot.series):
        color = _PALETTE[si % len(_PALETTE)]
        pts = " ".join(
            f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, ys) if y == y
        )
        parts.append(
            f'<polyline fill="none" stroke="{color}" stroke-width="2" '
            f'points="{pts}"/>'
        )
        parts.append(
            f'<text x="{width-pad+4}" y="{pad + 14*si}" font-size="11" '
            f'fill="{color}">{html.escape(name)}</text>'
        )
    parts.append("</svg>")
    return "".join(parts)


def render_html(doc: Document) -> str:
    out = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(doc.title)}</title>",
        "<style>body{font-family:sans-serif;margin:32px;max-width:960px}"
        "table{border-collapse:collapse;margin:12px 0}"
        "td,th{border:1px solid #ccc;padding:4px 10px;font-size:13px}"
        "th{background:#f0f0f0}h2{border-bottom:2px solid #3366cc}"
        "caption{font-size:12px;color:#555}</style></head><body>",
        f"<h1>{html.escape(doc.title)}</h1>",
    ]
    for ch in doc.chapters:
        out.append(f"<h2>{html.escape(ch.title)}</h2>")
        for sec in ch.sections:
            out.append(f"<h3>{html.escape(sec.title)}</h3>")
            for item in sec.items:
                if isinstance(item, Text):
                    out.append(f"<p>{html.escape(item.body)}</p>")
                elif isinstance(item, Table):
                    out.append("<table>")
                    if item.caption:
                        out.append(f"<caption>{html.escape(item.caption)}</caption>")
                    out.append(
                        "<tr>" + "".join(f"<th>{html.escape(h)}</th>" for h in item.header) + "</tr>"
                    )
                    for row in item.rows:
                        out.append(
                            "<tr>" + "".join(f"<td>{html.escape(str(c))}</td>" for c in row) + "</tr>"
                        )
                    out.append("</table>")
                elif isinstance(item, LinePlot):
                    out.append(_svg_line_plot(item))
    out.append("</body></html>")
    return "".join(out)


def write_html_report(doc: Document, path: str) -> None:
    from photon_ml_tpu_torch.reliability.artifacts import atomic_writer

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with atomic_writer(path, encoding="utf-8") as f:
        f.write(render_html(doc))


def render_text(doc: Document) -> str:
    """Plain-text render strategy (the reference's
    diagnostics/reporting/text/** StringRenderStrategy analog): chapters
    and sections as underlined headings, tables column-aligned, plots
    summarized as their series' (min, max, last) since text cannot carry
    an image."""
    lines: List[str] = [doc.title, "=" * len(doc.title), ""]
    for chapter in doc.chapters:
        lines += [chapter.title, "-" * len(chapter.title), ""]
        for section in chapter.sections:
            lines += [f"## {section.title}", ""]
            for item in section.items:
                if isinstance(item, Text):
                    lines += [item.body, ""]
                elif isinstance(item, Table):
                    # tolerate ragged rows like render_html does — both
                    # shorter AND longer than the header
                    def cell(row, c):
                        return str(row[c]) if c < len(row) else ""

                    ncols = max(
                        [len(item.header)] + [len(r) for r in item.rows]
                    )
                    widths = [
                        max(
                            len(cell(item.header, c)),
                            *(len(cell(r, c)) for r in item.rows),
                        )
                        if item.rows
                        else len(cell(item.header, c))
                        for c in range(ncols)
                    ]

                    def fmt(row):
                        return "  ".join(
                            cell(row, c).ljust(w)
                            for c, w in enumerate(widths)
                        ).rstrip()

                    if item.caption:
                        lines.append(item.caption)
                    lines.append(fmt(item.header))
                    lines.append("  ".join("-" * w for w in widths))
                    lines += [fmt(r) for r in item.rows]
                    lines.append("")
                elif isinstance(item, LinePlot):
                    lines.append(f"[plot] {item.title or 'line plot'}")
                    for name, ys in item.series:
                        finite = [y for y in ys if y == y]  # NaN filter,
                        # matching _svg_line_plot's guard
                        if finite:
                            lines.append(
                                f"  {name}: min={min(finite):.6g} "
                                f"max={max(finite):.6g} "
                                f"last={finite[-1]:.6g} "
                                f"({len(ys)} points)"
                            )
                    lines.append("")
    return "\n".join(lines).rstrip() + "\n"


def write_text_report(doc: Document, path: str) -> None:
    from photon_ml_tpu_torch.reliability.artifacts import atomic_writer

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with atomic_writer(path, encoding="utf-8") as f:
        f.write(render_text(doc))
