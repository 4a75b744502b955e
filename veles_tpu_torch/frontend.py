"""Frontend: the command-composer UI + unit-registry introspection (port
of ``veles_tpu/frontend.py``).

Reference capability: veles/__main__.py:258-332 (``--frontend`` tornado
page that composes a ``veles`` command line) and
veles/scripts/generate_frontend.py (builds frontend.html from every
registered unit's argparse contributions). Here: the registry dump is
a JSON document generated by introspecting the port's ``UnitRegistry``
(constructor signatures + docstrings); the page is one static HTML file
with vanilla JS that assembles a ``python -m veles_tpu_torch ...``
command line of the port's flags (``-l``/``-m`` for the farm's
coordinator and worker, ``-d cpu`` for the CPU; the card by default).
Serve it with ``python -m veles_tpu_torch.frontend [--port N]`` or
write it to disk with ``generate_frontend_html()``.
"""

from __future__ import annotations

import html
import inspect
import json
from typing import Any, Dict, List

from veles_tpu_torch.units import Unit, UnitRegistry


def registry_catalog() -> List[Dict[str, Any]]:
    """Introspect every registered unit class into plain data."""
    out = []
    for cls in sorted(UnitRegistry.units, key=lambda c: c.__name__):
        if not issubclass(cls, Unit):
            continue
        try:
            sig = inspect.signature(cls.__init__)
        except (TypeError, ValueError):
            continue
        params = []
        for name, param in sig.parameters.items():
            if name in ("self", "workflow", "kwargs"):
                continue
            params.append({
                "name": name,
                "default": repr(param.default)
                if param.default is not inspect.Parameter.empty else None,
            })
        out.append({
            "class": cls.__name__,
            "module": cls.__module__,
            "doc": inspect.getdoc(cls) or "",
            "params": params,
        })
    return out


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>veles_tpu_torch composer</title>
<style>
 body {{ font-family: sans-serif; margin: 2em; max-width: 60em; }}
 input, select {{ margin: 2px; }}
 #cmd {{ background: #eee; padding: 1em; font-family: monospace; }}
 details {{ margin: 4px 0; }}
</style></head><body>
<h2>veles_tpu_torch command composer</h2>
<p>workflow file: <input id="wf" size="40" value="workflow.py">
   config file: <input id="cfg" size="30" value="config.py"></p>
<p>mode: <select id="mode"><option>standalone</option>
  <option>coordinator</option><option>worker</option></select>
   address (coordinator -l / worker -m): <input id="addr" size="20"
   value="127.0.0.1:5555">
   device: <select id="device"><option value="">card</option>
  <option>cpu</option></select>
   snapshot (-w): <input id="snap" size="25"></p>
<p>overrides (key=value per line):<br>
   <textarea id="ovr" rows="3" cols="60"></textarea></p>
<div id="cmd"></div>
<h3>unit registry ({count} units)</h3>
{units}
<script>
function update() {{
  let parts = ["python", "-m", "veles_tpu_torch"];
  const mode = document.getElementById("mode").value;
  const addr = document.getElementById("addr").value;
  if (mode === "coordinator") parts.push("-l", addr);
  if (mode === "worker") parts.push("-m", addr);
  const device = document.getElementById("device").value;
  if (device) parts.push("-d", device);
  const snap = document.getElementById("snap").value;
  if (snap) parts.push("-w", snap);
  parts.push(document.getElementById("wf").value);
  parts.push(document.getElementById("cfg").value);
  for (const line of
       document.getElementById("ovr").value.split("\\n"))
    if (line.trim()) parts.push(line.trim());
  document.getElementById("cmd").textContent = parts.join(" ");
}}
for (const el of document.querySelectorAll("input, select, textarea"))
  el.addEventListener("input", update);
update();
</script></body></html>
"""


def generate_frontend_html() -> str:
    catalog = registry_catalog()
    blocks = []
    for entry in catalog:
        params = ", ".join(
            p["name"] + ("=" + p["default"] if p["default"] else "")
            for p in entry["params"]) or "—"
        blocks.append(
            "<details><summary><b>%s</b> <i>(%s)</i></summary>"
            "<p>kwargs: %s</p><pre>%s</pre></details>" %
            (html.escape(entry["class"]), html.escape(entry["module"]),
             html.escape(params),
             html.escape(entry["doc"].split("\n\n")[0])))
    return _PAGE.format(count=len(catalog), units="".join(blocks))


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(prog="veles_tpu_torch.frontend")
    parser.add_argument("--port", type=int, default=8480)
    parser.add_argument("--write", metavar="FILE",
                        help="write frontend.html and exit")
    parser.add_argument("--catalog", action="store_true",
                        help="print the registry catalog JSON and exit")
    args = parser.parse_args(argv)
    # import the full surface so the registry is populated
    import veles_tpu_torch.loader  # noqa: F401
    import veles_tpu_torch.nn  # noqa: F401
    import veles_tpu_torch.plotting  # noqa: F401

    if args.catalog:
        print(json.dumps(registry_catalog(), indent=2))
        return 0
    page = generate_frontend_html()
    if args.write:
        with open(args.write, "w") as fout:
            fout.write(page)
        print("wrote %s" % args.write)
        return 0
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a) -> None:
            pass

        def do_GET(self) -> None:
            body = page.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    print("frontend on http://127.0.0.1:%d" % args.port)
    httpd.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
