"""Publisher: end-of-train report generation (port of
``veles_tpu/publishing/publisher.py``).

Reference capability: veles/publishing/publisher.py:57 + backends —
gathers the trained workflow's facts (name, config, results, unit
stats, plots) and renders via Markdown/HTML/PDF/Confluence backends.
Here: a plain info-dict pipeline with pluggable render functions;
Markdown, HTML, JSON, Confluence storage XHTML and a notebook ship; PDF
needs matplotlib (``render_pdf`` raises ``ImportError`` without it).
The info dict holds host values only: the results come from
``Workflow.gather_results`` (host numbers), the device is its repr.
"""

from __future__ import annotations

import datetime
import html as html_mod
import json
import os
import platform
from typing import Any, Callable, Dict, Optional

from veles_tpu_torch.units import Unit


def gather_info(workflow) -> Dict[str, Any]:
    """Everything a report needs, as plain data."""
    info: Dict[str, Any] = {
        "workflow": type(workflow).__name__,
        "generated": datetime.datetime.now().isoformat(timespec="seconds"),
        "host": platform.node(),
        "results": workflow.gather_results(),
        "run_time": getattr(workflow, "total_run_time", None),
        "units": [],
    }
    for unit in workflow.units_in_dependency_order:
        info["units"].append({
            "name": unit.name,
            "class": type(unit).__name__,
            "run_time": float(getattr(unit, "total_run_time", 0.0) or 0.0),
        })
    device = getattr(workflow, "device", None)
    if device is not None:
        info["device"] = repr(device)
    return info


def render_markdown(info: Dict[str, Any]) -> str:
    lines = ["# Training report: %s" % info["workflow"], "",
             "- generated: %s on %s" % (info["generated"], info["host"])]
    if info.get("device"):
        lines.append("- device: %s" % info["device"])
    if info.get("run_time") is not None:
        lines.append("- total run time: %.1f s" % info["run_time"])
    lines += ["", "## Results", ""]
    for key, value in sorted(info["results"].items()):
        lines.append("- **%s**: %s" % (key, value))
    lines += ["", "## Unit run times", "",
              "| unit | class | time (s) |", "|---|---|---|"]
    for u in sorted(info["units"], key=lambda u: -u["run_time"]):
        lines.append("| %s | %s | %.3f |" %
                     (u["name"], u["class"], u["run_time"]))
    return "\n".join(lines) + "\n"


def render_html(info: Dict[str, Any]) -> str:
    md = render_markdown(info)
    # minimal md -> html: headings, bold, tables, list items
    out = ["<!doctype html><html><head><meta charset='utf-8'>"
           "<title>%s</title></head><body><pre>"
           % html_mod.escape(info["workflow"]),
           html_mod.escape(md), "</pre></body></html>"]
    return "".join(out)


def render_json(info: Dict[str, Any]) -> str:
    return json.dumps(info, indent=2, default=str) + "\n"


def render_pdf(info: Dict[str, Any]) -> bytes:
    """PDF backend (reference: veles/publishing pdf backend) rendered
    with matplotlib's Agg/PdfPages — no LaTeX, no external tools.
    Page 1: header + results; page 2: unit run-time chart + table."""
    import io

    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.backends.backend_pdf import PdfPages
    from matplotlib.figure import Figure

    buf = io.BytesIO()
    with PdfPages(buf) as pdf:
        fig = Figure(figsize=(8.27, 11.69))  # A4 portrait
        fig.text(0.08, 0.94, "Training report: %s" % info["workflow"],
                 fontsize=18, weight="bold")
        meta = ["generated: %s on %s" % (info["generated"],
                                         info["host"])]
        if info.get("device"):
            meta.append("device: %s" % info["device"])
        if info.get("run_time") is not None:
            meta.append("total run time: %.1f s" % info["run_time"])
        fig.text(0.08, 0.90, "\n".join(meta), fontsize=10, va="top")
        lines = ["%s: %s" % (k, v)
                 for k, v in sorted(info["results"].items())]
        fig.text(0.08, 0.80, "Results", fontsize=14, weight="bold")
        fig.text(0.08, 0.775, "\n".join(lines[:40]) or "(none)",
                 fontsize=10, va="top", family="monospace")
        pdf.savefig(fig)

        units = sorted(info["units"], key=lambda u: -u["run_time"])
        fig2 = Figure(figsize=(8.27, 11.69))
        top = [u for u in units if u["run_time"] > 0][:20]
        if top:
            ax = fig2.add_axes([0.3, 0.55, 0.62, 0.38])
            names = ["%s" % u["name"] for u in reversed(top)]
            times = [u["run_time"] for u in reversed(top)]
            ax.barh(range(len(top)), times)
            ax.set_yticks(range(len(top)))
            ax.set_yticklabels(names, fontsize=7)
            ax.set_xlabel("run time (s)")
            ax.set_title("Unit run times")
        rows = "\n".join("%-28s %-24s %8.3f" %
                         (u["name"][:28], u["class"][:24], u["run_time"])
                         for u in units[:45])
        fig2.text(0.08, 0.50, "All units", fontsize=14, weight="bold")
        fig2.text(0.08, 0.475, rows or "(none)", fontsize=7, va="top",
                  family="monospace")
        pdf.savefig(fig2)
    return buf.getvalue()


def render_confluence(info: Dict[str, Any]) -> str:
    """Confluence storage-format XHTML (reference:
    veles/publishing/confluence_backend.py posted pages through the
    wiki REST API). The document this returns is what
    :func:`publish_confluence` ships as the page body."""
    esc = html_mod.escape
    parts = ["<h1>Training report: %s</h1>" % esc(info["workflow"]),
             "<p>generated: %s on %s</p>" % (esc(info["generated"]),
                                             esc(info["host"]))]
    if info.get("device"):
        parts.append("<p>device: %s</p>" % esc(str(info["device"])))
    if info.get("run_time") is not None:
        parts.append("<p>total run time: %.1f s</p>" % info["run_time"])
    parts.append("<h2>Results</h2><table><tbody>")
    for key, value in sorted(info["results"].items()):
        parts.append("<tr><th>%s</th><td>%s</td></tr>" %
                     (esc(str(key)), esc(str(value))))
    parts.append("</tbody></table><h2>Unit run times</h2>"
                 "<table><tbody><tr><th>unit</th><th>class</th>"
                 "<th>time (s)</th></tr>")
    for u in sorted(info["units"], key=lambda u: -u["run_time"]):
        parts.append("<tr><td>%s</td><td>%s</td><td>%.3f</td></tr>" %
                     (esc(u["name"]), esc(u["class"]), u["run_time"]))
    parts.append("</tbody></table>")
    return "".join(parts)


def publish_confluence(workflow, base_url: str, space: str,
                       title: Optional[str] = None,
                       token: Optional[str] = None,
                       timeout: float = 30.0) -> Dict[str, Any]:
    """Create a Confluence page holding the training report
    (reference: veles/publishing/confluence_backend.py). ``base_url``
    is the wiki root (the REST endpoint ``/rest/api/content`` is
    appended); ``token`` is a bearer token. Returns the server's JSON
    response."""
    import urllib.error
    import urllib.request
    info = gather_info(workflow)
    doc = {
        "type": "page",
        "title": title or ("Training report: %s %s" %
                           (info["workflow"], info["generated"])),
        "space": {"key": space},
        "body": {"storage": {"value": render_confluence(info),
                             "representation": "storage"}},
    }
    req = urllib.request.Request(
        base_url.rstrip("/") + "/rest/api/content",
        data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    if token:
        req.add_header("Authorization", "Bearer %s" % token)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        # surface the wiki's own diagnosis ("a page with this title
        # already exists", bad space key, ...), not just the status
        detail = e.read().decode("utf-8", "replace")[:1000]
        raise RuntimeError(
            "confluence rejected the page (%d): %s" %
            (e.code, detail)) from e


def render_ipynb(info: Dict[str, Any]) -> str:
    """Jupyter-notebook report (reference: the IPython-notebook
    template backend in veles/publishing/). Emits nbformat-4 JSON:
    a title cell, a results/metadata markdown cell, the raw info dict
    in a code cell (so the notebook is itself analyzable), and a
    ready-to-run cell plotting the unit run times."""
    md_meta = ["generated: %s on %s" % (info["generated"],
                                        info["host"])]
    if info.get("device"):
        md_meta.append("device: %s" % info["device"])
    if info.get("run_time") is not None:
        md_meta.append("total run time: %.1f s" % info["run_time"])
    results_lines = ["- **%s**: %s" % (k, v)
                     for k, v in sorted(info["results"].items())]

    def md_cell(text):
        return {"cell_type": "markdown", "metadata": {},
                "source": text.splitlines(keepends=True)}

    def code_cell(text):
        return {"cell_type": "code", "metadata": {},
                "execution_count": None, "outputs": [],
                "source": text.splitlines(keepends=True)}

    nb = {
        "nbformat": 4,
        "nbformat_minor": 5,
        "metadata": {
            "kernelspec": {"name": "python3",
                           "display_name": "Python 3",
                           "language": "python"},
            "veles_tpu_torch": {"workflow": info["workflow"],
                          "generated": info["generated"]},
        },
        "cells": [
            md_cell("# Training report: %s\n\n%s" %
                    (info["workflow"], "\n".join(md_meta))),
            md_cell("## Results\n\n" +
                    ("\n".join(results_lines) or "(none)")),
            # json.loads(<python string literal>) rather than a bare
            # dict literal: the JSON text may contain null/true/false,
            # which are not Python
            code_cell("import json\ninfo = json.loads(%r)\n"
                      "info[\"results\"]\n" %
                      json.dumps(info, default=str)),
            code_cell(
                "import matplotlib.pyplot as plt\n"
                "units = sorted(info['units'],\n"
                "               key=lambda u: -u['run_time'])[:20]\n"
                "plt.barh([u['name'] for u in reversed(units)],\n"
                "         [u['run_time'] for u in reversed(units)])\n"
                "plt.xlabel('run time (s)')\n"
                "plt.title('Unit run times')\n"
                "plt.tight_layout()\n"),
        ],
    }
    return json.dumps(nb, indent=1) + "\n"


BACKENDS: Dict[str, Callable[[Dict[str, Any]], Any]] = {
    "markdown": render_markdown,
    "html": render_html,
    "json": render_json,
    "pdf": render_pdf,
    "confluence": render_confluence,
    "ipynb": render_ipynb,
}

_EXT = {"markdown": ".md", "html": ".html", "json": ".json",
        "pdf": ".pdf", "confluence": ".xhtml", "ipynb": ".ipynb"}


def render_report(workflow, backend: str = "markdown",
                  directory: str = ".",
                  basename: Optional[str] = None) -> str:
    """Render + write; returns the report path."""
    if backend not in BACKENDS:
        raise ValueError("unknown publishing backend %r (have %s)" %
                         (backend, sorted(BACKENDS)))
    info = gather_info(workflow)
    os.makedirs(directory, exist_ok=True)
    name = basename or ("report_%s" % info["workflow"])
    path = os.path.join(directory, name + _EXT.get(backend, ".txt"))
    doc = BACKENDS[backend](info)
    mode = "wb" if isinstance(doc, bytes) else "w"
    with open(path, mode) as fout:
        fout.write(doc)
    return path


class Publisher(Unit):
    """Unit form: link from the decision/end so it fires once training
    completes (gate on decision.complete as the reference did)."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.backend: str = kwargs.pop("backend", "markdown")
        self.directory: str = kwargs.pop("directory", ".")
        kwargs.setdefault("view_group", "SERVICE")
        super().__init__(workflow, **kwargs)
        self.report_path: Optional[str] = None

    def run(self) -> None:
        self.report_path = render_report(
            self.workflow, self.backend, self.directory)
        self.info("published %s", self.report_path)
