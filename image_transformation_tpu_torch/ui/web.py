# Copy of image_transformation_tpu/ui/web.py (host-only; the module path in the usage lines is this package's).
"""Zero-dependency web artifact viewer (stdlib http.server).

The Streamlit apps need the streamlit package; this viewer serves the same
artifact surface (runs -> iterations -> drafts/overlays/layouts/critiques/
timings) as plain HTML over the standard library:

    python -m image_transformation_tpu_torch.ui.web [--root output_macro_placement]
                                              [--port 8501] [--host 127.0.0.1]

Routes:
    /                     run list
    /run/<stem>           iteration browser (images inline)
    /file/<stem>/<rel>    artifact file (path-traversal-safe, root-jailed)
    /api/runs             JSON run list
    /api/run/<stem>       JSON report (same shape as ui.console.show_run)
"""

from __future__ import annotations

import argparse
import html
import json
import mimetypes
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import quote, unquote

from .console import list_runs, show_run


def _safe_stem(stem: str) -> str:
    """Reject path separators/traversal in run stems (URL-supplied)."""
    if not stem or "/" in stem or "\\" in stem or ".." in stem:
        raise FileNotFoundError(stem)
    return stem

_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>{title}</title><style>
body {{ font-family: system-ui, sans-serif; margin: 2rem; color: #222; }}
h1, h2 {{ font-weight: 600; }}
table {{ border-collapse: collapse; }}
td, th {{ padding: 4px 12px; border-bottom: 1px solid #ddd; text-align: left; }}
img {{ max-width: 420px; border: 1px solid #ccc; margin: 4px 8px 4px 0;
      vertical-align: top; }}
pre {{ background: #f6f6f6; padding: 8px; overflow-x: auto; }}
.iter {{ border: 1px solid #e0e0e0; border-radius: 6px; padding: 12px;
        margin: 14px 0; }}
.badge {{ background: #eee; border-radius: 4px; padding: 1px 6px;
         font-size: 0.85em; }}
a {{ color: #0a62c9; text-decoration: none; }}
</style></head><body>{body}</body></html>"""


def _render_index(root: Path) -> str:
    runs = list_runs(root)
    if not runs:
        body = f"<h1>Macro placement runs</h1><p>No runs under <code>{html.escape(str(root))}</code>.</p>"
        return _PAGE.format(title="runs", body=body)
    rows = "".join(
        f"<tr><td><a href='/run/{quote(r['stem'])}'>{html.escape(r['stem'])}</a></td>"
        f"<td>{r['iterations']}</td><td>{r['last_iteration']:02d}</td>"
        f"<td>{'yes' if r['has_time_log'] else 'no'}</td></tr>"
        for r in runs
    )
    body = (
        "<h1>Macro placement runs</h1>"
        "<table><tr><th>run</th><th>iterations</th><th>last</th>"
        f"<th>time log</th></tr>{rows}</table>"
    )
    return _PAGE.format(title="runs", body=body)


def _img_tag(root: Path, stem: str, path_str) -> str:
    if not path_str:
        return ""
    rel = Path(path_str).resolve().relative_to((root / stem).resolve())
    # percent-encode the URL path segments (html.escape is NOT URL
    # encoding: a stem like "50%_off" or "promo?v2" would otherwise make
    # a broken link for a run that exists)
    return f"<img src='/file/{quote(stem)}/{quote(str(rel))}'>"


def _render_run(root: Path, stem: str) -> str:
    report = show_run(root, _safe_stem(stem))
    parts = [f"<h1>{html.escape(stem)}</h1><p><a href='/'>&larr; all runs</a></p>"]
    for it in report["iterations"]:
        sec = [f"<div class='iter'><h2>iteration {it['iteration']:02d}</h2>"]
        if it.get("no_change"):
            sec.append("<p><span class='badge'>no change — compose skipped</span></p>")
        sec.append(_img_tag(root, stem, it.get("draft")))
        sec.append(_img_tag(root, stem, it.get("overlay")))
        canvas = it.get("canvas")
        if canvas:
            sec.append(
                f"<p>canvas {canvas.get('width')}x{canvas.get('height')} "
                f"margin={canvas.get('margin')} align={canvas.get('align')}</p>"
            )
        placements = it.get("placements", [])
        if placements:
            rows = "".join(
                f"<tr><td>{p.get('object_id')}</td>"
                f"<td>{html.escape(str(p.get('name') or ''))}</td>"
                f"<td>{p.get('box')}</td><td>{p.get('scale')}</td></tr>"
                for p in placements
            )
            sec.append(
                "<table><tr><th>id</th><th>name</th><th>box</th>"
                f"<th>scale</th></tr>{rows}</table>"
            )
        if it.get("validation_error"):
            sec.append(
                f"<p>validation error:</p><pre>{html.escape(it['validation_error'])}</pre>"
            )
        if it.get("critique"):
            sec.append(f"<p>critique:</p><pre>{html.escape(it['critique'])}</pre>")
        sec.append("</div>")
        parts.append("".join(sec))
    if report.get("time_log"):
        parts.append(f"<h2>timings</h2><pre>{html.escape(report['time_log'])}</pre>")
    return _PAGE.format(title=stem, body="".join(parts))


def make_handler(root: Path):
    root = root.resolve()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet server
            pass

        def _send(self, code: int, content: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(content)))
            self.end_headers()
            self.wfile.write(content)

        def _html(self, text: str, code: int = 200) -> None:
            self._send(code, text.encode("utf-8"), "text/html; charset=utf-8")

        def _json(self, obj, code: int = 200) -> None:
            self._send(code, json.dumps(obj).encode("utf-8"), "application/json")

        def do_GET(self):  # noqa: N802 - stdlib API
            try:
                path = unquote(self.path.split("?", 1)[0])
                if path == "/":
                    return self._html(_render_index(root))
                if path == "/api/runs":
                    return self._json(list_runs(root))
                if path.startswith("/api/run/"):
                    return self._json(
                        show_run(root, _safe_stem(path[len("/api/run/"):]))
                    )
                if path.startswith("/run/"):
                    return self._html(
                        _render_run(root, _safe_stem(path[len("/run/"):]))
                    )
                if path.startswith("/file/"):
                    target = (root / path[len("/file/"):]).resolve()
                    if not target.is_relative_to(root):  # jail to the root
                        return self._html("forbidden", 403)
                    if not target.is_file():
                        return self._html("not found", 404)
                    ctype = mimetypes.guess_type(str(target))[0] or "application/octet-stream"
                    return self._send(200, target.read_bytes(), ctype)
                return self._html("not found", 404)
            except FileNotFoundError:
                return self._html("not found", 404)
            except Exception as e:  # noqa: BLE001 - keep the server alive
                return self._html(f"error: {html.escape(str(e))}", 500)

    return Handler


def serve(root, host: str = "127.0.0.1", port: int = 8501):
    """Build the server (callers run .serve_forever(); tests drive it)."""
    return ThreadingHTTPServer((host, port), make_handler(Path(root)))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Web artifact viewer")
    parser.add_argument("--root", default="output_macro_placement")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8501)
    args = parser.parse_args(argv)
    server = serve(args.root, args.host, args.port)
    print(f"serving {args.root} on http://{args.host}:{args.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
