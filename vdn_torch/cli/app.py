"""Web demo: image -> depth round trip (vdn/cli/app.py; reference
app.py:1-87).

The reference uses gradio (+ImageSlider); the same capability rides a
stdlib http.server: upload an image, get the Spectral_r-colored depth, the
8-bit grayscale map, and the 16-bit raw (disparity) PNG back, the
reference demo's three outputs.  Decoding and encoding the PNGs needs cv2
and matplotlib, imported per request.

Usage:
  python -m vdn_torch.cli.app --encoder vits [--checkpoint ckpt.pth] \
      [--port 7860] [--device cuda]

Without ``--checkpoint`` the model takes the port's seeded initializers
(vdn_torch.models.presets.build_preset, seed 0): random weights for a
smoke run, not the draws of vdn's ``jax.random.PRNGKey(0)`` init.
"""

from __future__ import annotations

import argparse
import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>Depth Anything V2 (vdn_torch)</title><style>
body { font-family: sans-serif; max-width: 960px; margin: 2em auto; }
img { max-width: 45%; border: 1px solid #ccc; margin: 4px; }
</style></head><body>
<h1>Depth Anything V2 — vdn_torch demo</h1>
<p>Upload an image to compute relative depth.</p>
<input type="file" id="file" accept="image/*">
<button onclick="run()">Compute Depth</button>
<div id="out"></div>
<script>
async function run() {
  const f = document.getElementById('file').files[0];
  if (!f) return;
  const buf = await f.arrayBuffer();
  const r = await fetch('/predict', {method: 'POST', body: buf});
  const j = await r.json();
  document.getElementById('out').innerHTML =
    '<img src="data:image/png;base64,' + j.input + '">' +
    '<img src="data:image/png;base64,' + j.colored + '">' +
    '<p><a download="depth_gray.png" href="data:image/png;base64,' +
    j.gray + '">grayscale depth</a> | ' +
    '<a download="depth_raw16.png" href="data:image/png;base64,' +
    j.raw16 + '">16-bit raw</a></p>';
}
</script></body></html>"""


def _png_b64(arr: np.ndarray) -> str:
    import cv2
    ok, buf = cv2.imencode(".png", arr)
    assert ok
    return base64.b64encode(buf.tobytes()).decode()


def make_handler(pipeline):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            body = _PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            import cv2
            import matplotlib
            n = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(n)
            img = cv2.imdecode(np.frombuffer(data, np.uint8),
                               cv2.IMREAD_COLOR)  # BGR
            if img is None:
                self.send_response(400)
                self.end_headers()
                return
            depth = pipeline.infer_image(img)  # reference takes BGR
            norm = (depth - depth.min()) / max(
                float(depth.max() - depth.min()), 1e-8) * 255.0
            gray = norm.astype(np.uint8)
            cmap = matplotlib.colormaps.get_cmap("Spectral_r")
            colored = (cmap(gray)[:, :, :3] * 255).astype(np.uint8)
            payload = json.dumps({
                "input": _png_b64(img),
                "colored": _png_b64(colored[:, :, ::-1]),  # RGB -> BGR png
                "gray": _png_b64(gray),
                "raw16": _png_b64(depth.astype(np.uint16)),
            }).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    return Handler


class _DemoPipeline:
    """Stateless per-request wrapper: the memory bank is cleared between
    uploads (each request is an independent image, unlike the stateful
    video-ish usage of DepthAnythingV2Pipeline)."""

    def __init__(self, pipe, input_size: int):
        self.pipe = pipe
        self.input_size = input_size

    def infer_image(self, raw_bgr):
        self.pipe.clear_memory()
        return self.pipe.infer_image(raw_bgr, self.input_size)


def build_pipeline(encoder: str, checkpoint=None, input_size: int = 518,
                   device: str = "cuda"):
    """The demo's bf16 DepthAnythingV2Pipeline, with the checkpoint's
    weights or, without one, the seeded initializers."""
    from vdn_torch.models.depth_anything_v2 import build_depth_anything_v2
    from vdn_torch.pipelines.infer_image import DepthAnythingV2Pipeline

    model = build_depth_anything_v2(encoder, compute_dtype="bf16",
                                    device=device)
    if checkpoint:
        from vdn_torch.core.checkpoint import load_checkpoint
        load_checkpoint(model, checkpoint)
    return _DemoPipeline(DepthAnythingV2Pipeline(model), input_size)


def serve(pipeline, port: int = 7860, background: bool = False):
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(pipeline))
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server
    print(f"serving on http://0.0.0.0:{port}")
    server.serve_forever()


def main(argv=None):
    ap = argparse.ArgumentParser(description="vdn_torch depth web demo")
    ap.add_argument("--encoder", default="vitl",
                    choices=["vits", "vitb", "vitl", "vitg"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--input-size", type=int, default=518)
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    serve(build_pipeline(args.encoder, args.checkpoint, args.input_size,
                         args.device), args.port)


if __name__ == "__main__":
    main()
