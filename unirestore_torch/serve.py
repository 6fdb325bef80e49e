"""Restore server on the card (stdlib HTTP), the port of ``tools/serve.py``.

    POST /restore?task=ir[&steps=20]   body: image bytes -> PNG bytes
    GET  /healthz                      -> {"status": "ok", "tasks": [...], "served": n,
                                           "cache_mode": "..."}

Run from the repository root:

    python -m unirestore_torch.serve --port 8400 [--fused-out-attn] [--cuda-graphs]
    python -m unirestore_torch.serve --device cpu --tiny ...   # on the CPU
    curl -X POST --data-binary @degraded.png "localhost:8400/restore?task=ir" -o restored.png

Inputs of any size go through the tiled overlap-blend path
(``ops/tiling.py``): images no larger than the working tile restore directly
(resize and pad inside ``restore``), larger ones as fixed-shape batches of
``--batch-tiles`` tiles. Requests run one at a time on the device, under a
lock. Each tile batch draws its posterior and diffusion noise from a fresh
``torch.Generator`` seeded 0, as the JAX server restores every call with
``PRNGKey(0)``. Weights: seeded init, then the converted sd-turbo files and
null embedding found in ``--weights-dir`` (``zoo.py``), then the adapters of
``--checkpoint``; bf16 unless ``--tiny``. With ``--cuda-graphs`` (off by
default; the card only) every restore replays a CUDA graph of the whole
restore (``graphs.GraphedRestore``), keyed as the JAX server keys its
compiled programs, by (batch shape, task, steps): one graph per (task, steps)
for the fixed-shape tile batches, and one per image shape besides for images
restored whole; at most 16, the least recently used evicted.

Differences from the JAX server: ``--device`` (default: the current CUDA
device, which must exist) replaces ``--platform``; ``--fused-out-attn`` sets
``UniRestoreConfig.fused_out_attention``; ``--weights-dir`` replaces the
``UNIRESTORE_WEIGHTS`` variable; PNG is read and written by ``ops/png.py``
without PIL, and other formats go to PIL when it imports, else get HTTP 415;
the JAX server always runs its compiled programs (an LRU of 16 ``jax.jit``
restores), this one runs eagerly unless ``--cuda-graphs`` turns on its
counterpart, an LRU of 16 CUDA graphs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from . import bridge, zoo
from . import graphs as GR
from .device import resolve_device
from .models import unirestore as UR
from .ops import png
from .ops import tiling as TIL


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("unirestore-torch-serve")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8400)
    ap.add_argument("--tasks", default="ir,cls,seg")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--cache-mode", default="none", choices=["none", "encoder", "deep"])
    ap.add_argument("--cache-stride", type=int, default=5)
    ap.add_argument("--cache-warmup", type=int, default=0)
    ap.add_argument("--checkpoint", default=None, help="trained adapter checkpoint (.npz)")
    ap.add_argument("--batch-tiles", type=int, default=4)
    ap.add_argument("--overlap", type=int, default=64)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; 'cpu' for tests)")
    ap.add_argument("--fused-out-attn", action="store_true",
                    help="fuse the attention out-projection into the channel-flat kernel")
    ap.add_argument("--weights-dir", default=zoo.DEFAULT_WEIGHTS,
                    help="converted sd-turbo weights and sd_null_emb.npy")
    ap.add_argument("--cuda-graphs", action="store_true",
                    help="replay each restore from a CUDA graph (the card only)")
    return ap.parse_args(argv)


def build_restore(args, noise_fn=None):
    """Returns (restore, cfg): ``restore(images, task, steps=None)`` takes and
    gives (B, H, W, 3) float32 numpy in [0, 1].

    ``noise_fn(latent_shape) -> (posterior_noise, diffusion_noise)``, if given,
    supplies each tile batch's noise in place of the seeded generator's draws.
    ``restore.graphs`` is the ``graphs.GraphedRestore`` that ``--cuda-graphs``
    routes every tile batch through (its ``stats`` per key), else None.
    """
    dev = resolve_device(args.device)
    tasks = tuple(args.tasks.split(","))
    cfg = (UR.tiny_config(tasks=tasks) if args.tiny
           else UR.UniRestoreConfig(use_tfa=True, tasks=tasks))
    cfg = dataclasses.replace(cfg, cache_mode=args.cache_mode, cache_stride=args.cache_stride,
                              cache_warmup=args.cache_warmup,
                              fused_out_attention=args.fused_out_attn)
    frozen, trainable = UR.init(cfg, device=dev, seed=0)
    frozen = zoo.load_frozen_backbone(frozen, cfg, args.weights_dir)
    if args.checkpoint:
        from .train import checkpoints as CKPT
        trainable, _ = CKPT.load_trainable(args.checkpoint, trainable)
    sched = UR.schedule(cfg, device=dev)
    dt = torch.float32 if args.tiny else torch.bfloat16
    frozen, trainable = bridge.cast_tree(frozen, dt), bridge.cast_tree(trainable, dt)
    graphs = (GR.GraphedRestore(frozen, trainable, cfg, sched, device=dev) if args.cuda_graphs
              else None)

    def base(images, task, steps):
        # numpy keeps a caller's axis order through slicing and np.stack, and
        # on the card a bf16 restore of a strided batch rounds differently
        # (other conv algorithms): every batch goes in C-contiguous, so an
        # answer does not depend on how the caller's array was laid out
        x = torch.as_tensor(images, device=dev).to(dt).contiguous()
        noise = {}
        if noise_fn is not None:
            h, w, ph, pw = UR.preprocess_shape(x.shape[1], x.shape[2], cfg)
            lat = (x.shape[0], (h + ph) // 8, (w + pw) // 8, cfg.vae.latent_channels)
            post, diff = noise_fn(lat)
            noise = {"posterior_noise": torch.as_tensor(post, device=dev).to(dt),
                     "diffusion_noise": torch.as_tensor(diff, device=dev).to(dt)}
        gen = torch.Generator(device=dev).manual_seed(0)
        if graphs is None:
            out = UR.restore(frozen, trainable, cfg, sched, x, task, gen, steps, device=dev,
                             **noise)
        else:
            out = graphs(x, task, gen, steps, **noise)
        return out.float().cpu().numpy()

    def restore(images, task, steps=None):
        steps = steps or args.steps
        return TIL.restore_tiled(lambda im, t: base(im, t, steps), images, task,
                                 tile=cfg.min_size, overlap=args.overlap,
                                 batch_tiles=args.batch_tiles)

    restore.graphs = graphs
    return restore, cfg


def make_handler(restore, cfg, lock, stats):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet
            pass

        def _send(self, code, body: bytes, content_type: str):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._json(200, {"status": "ok", "tasks": list(cfg.tasks),
                                 "served": stats["served"], "cache_mode": cfg.cache_mode})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if not self.path.startswith("/restore"):
                self._json(404, {"error": "unknown path"})
                return
            q = parse_qs(urlparse(self.path).query)
            task = q.get("task", ["ir"])[0]
            if task not in cfg.tasks:
                self._json(400, {"error": f"unknown task {task!r}", "tasks": list(cfg.tasks)})
                return
            try:
                steps = int(q["steps"][0]) if "steps" in q else None
            except ValueError:
                self._json(400, {"error": "steps must be an integer"})
                return
            raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                img = png.read_rgb(raw)
            except png.UnsupportedImage as e:
                self._json(415, {"error": f"unsupported image: {e}"})
                return
            except Exception as e:
                self._json(400, {"error": f"bad image: {e}"})
                return
            arr = np.asarray(img, np.float32)[None] / 255.0
            try:
                with lock:  # one device, serialized execution
                    out = restore(arr, task, steps=steps)[0]
            except Exception as e:  # surface model failures as 500
                self._json(500, {"error": f"restore failed: {e}"})
                return
            body = png.encode(np.clip(out * 255.0, 0, 255).astype(np.uint8))
            with stats["lock"]:
                stats["served"] += 1
            self._send(200, body, "image/png")

    return Handler


def make_server(args, restore=None, cfg=None) -> ThreadingHTTPServer:
    """An HTTP server on (args.host, args.port) over ``build_restore(args)``'s
    function, or over ``restore`` and ``cfg`` when given; port 0 picks a free one."""
    if restore is None:
        restore, cfg = build_restore(args)
    stats = {"served": 0, "lock": threading.Lock()}
    return ThreadingHTTPServer((args.host, args.port),
                               make_handler(restore, cfg, threading.Lock(), stats))


def main(argv=None) -> None:
    args = parse_args(argv)
    server = make_server(args)
    host, port = server.server_address[:2]
    print(f"[serve] listening on {host}:{port} device={resolve_device(args.device)} "
          f"tasks={args.tasks} steps={args.steps} cache={args.cache_mode} "
          f"fused_out_attn={args.fused_out_attn} cuda_graphs={args.cuda_graphs}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
