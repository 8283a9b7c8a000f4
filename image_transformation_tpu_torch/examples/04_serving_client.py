"""The HTTP serving daemon on the GPU: buffered render + chunked NDJSON.

The port of examples/04_serving_client.py. Starts the daemon in process on
an ephemeral localhost port, fetches one PNG through the buffered
/v1/render path (K1), then streams a multi-ratio batch (K2) as chunked
NDJSON ("stream": true): each line arrives as soon as its variant is
encoded.

    python image_transformation_tpu_torch/examples/04_serving_client.py [--device cpu]
"""
import argparse
import json
import sys
import tempfile
import threading
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from image_transformation_tpu_torch.serving import ComposeService, serve  # noqa: E402


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    out_dir = Path(tempfile.gettempdir())
    service = ComposeService(REPO / "data", device=args.device,
                             manifest_path=out_dir / "itpu_torch_example_serving_steps.json")
    server = serve(REPO / "data", port=0, service=service)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        def post(path, payload):
            return urllib.request.urlopen(urllib.request.Request(
                base + path, data=json.dumps(payload).encode(),
                method="POST", headers={"Content-Type": "application/json"},
            ), timeout=600)

        # buffered: one PNG body
        with post("/v1/render", {"bundle": "squarespace", "ratio": "1:1"}) as r:
            png = r.read()
        png_path = out_dir / "itpu_torch_example_serving.png"
        png_path.write_bytes(png)
        print(f"/v1/render -> {len(png)} PNG bytes -> {png_path}")

        # streaming: one NDJSON line per ratio, readable incrementally
        with post("/v1/render_batch", {
            "bundle": "squarespace", "ratios": ["9:16", "1:1", "16:9"],
            "stream": True,
        }) as r:
            for raw in r:
                if not raw.strip():
                    continue
                line = json.loads(raw)
                print(f"stream: ratio={line['ratio']} "
                      f"canvas={line['canvas']['width']}x"
                      f"{line['canvas']['height']} "
                      f"png_b64={len(line['png_b64'])} chars")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
        service.close()  # joins the drain worker (it calibrates at idle)


if __name__ == "__main__":
    main()
