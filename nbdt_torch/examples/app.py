"""NBDT inference over HTTP (the reference's ``examples/app``).

Counterpart of ``examples/app/api.py``, on the standard library's
``ThreadingHTTPServer``. ``POST /`` with JSON ``{"url": ...}`` (a URL or a
local path) or the raw bytes of an image answers
``{"prediction": ..., "decisions": [{"name": ..., "prob": ...}, ...]}``;
``GET /`` answers a usage note; a request that fails answers 400 with
``{"error": ...}``. The model is built once, at start-up, on ``--device``
(the card by default).

    python -m nbdt_torch.examples.app --checkpoint ckpt.pth [--arch ResNet18] \\
        [--dataset CIFAR10] [--port 5000] [--hard] [--fold-bn] [--device cpu]
    python -m nbdt_torch.examples.app --random-init --port 0   # offline demo, any free port

(``examples/app/run.sh`` is ``python api.py --port 5000 "$@"``; here that is
``python -m nbdt_torch.examples.app --port 5000 "$@"``.)
"""

from __future__ import annotations

import argparse
import io
import json
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..bin.nbdt import preprocess
from ..model import HardNBDT, SoftNBDT
from ..models import get_model, init_model
from .load_pretrained import build_nbdt
from ..utils import DATASET_TO_NUM_CLASSES, default_image_size, load_image_from_path


def build_model(args):
    """The served NBDT: ``--checkpoint``'s weights, or with
    ``--random-init`` a seeded random backbone; an induced hierarchy that is
    not vendored is induced from the classifier it serves."""
    num_classes = DATASET_TO_NUM_CLASSES[args.dataset]
    if args.checkpoint is None and args.random_init:
        size = default_image_size(args.dataset)
        module = init_model(args.arch, num_classes, (size, size, 3), device=args.device)
        checkpoint = None
    else:
        module, checkpoint = get_model(args.arch, num_classes), args.checkpoint
    return build_nbdt(HardNBDT if args.hard else SoftNBDT, module, args.dataset, args.arch,
                      hierarchy=args.hierarchy, checkpoint=checkpoint, path_graph=args.path_graph,
                      fold_bn=getattr(args, "fold_bn", False), device=args.device)


def make_handler(model):
    """The request handler class serving ``model``."""

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._reply(200, {"status": "ok", "usage": "POST {url: ...} or image bytes"})

        def do_POST(self):
            try:
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if "application/json" in self.headers.get("Content-Type", ""):
                    image = load_image_from_path(json.loads(raw)["url"])
                else:  # raw image bytes
                    from PIL import Image

                    image = Image.open(io.BytesIO(raw))
                outputs, decisions = model.forward_with_decisions(preprocess(image))
                pred = int(outputs.argmax(1)[0])
                self._reply(200, {
                    "prediction": model.tree.classes[pred],
                    "decisions": [{"name": d["name"], "prob": round(float(d["prob"]), 4)}
                                  for d in decisions[0]],
                })
            except Exception as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):
            sys.stderr.write("[api] " + fmt % args + "\n")

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--arch", default="ResNet18")
    parser.add_argument("--dataset", default="CIFAR10")
    parser.add_argument("--hierarchy", default=None)
    parser.add_argument("--path-graph", default=None)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--hard", action="store_true")
    parser.add_argument("--fold-bn", action="store_true",
                        help="serve the BN-folded forward (ResNet family; same predictions, "
                             "fewer ops)")
    parser.add_argument("--random-init", action="store_true",
                        help="serve random weights with a hierarchy induced from them "
                             "(offline demo: no checkpoint, no download)")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    if args.checkpoint is None and not args.random_init:
        parser.error("no --checkpoint given; pass one, or --random-init for an offline demo "
                     "(released weights cannot be downloaded without network access)")

    server = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(build_model(args)))
    print(f"Serving NBDT on :{server.server_address[1]}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
