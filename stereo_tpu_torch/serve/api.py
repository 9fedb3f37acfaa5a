"""REST serving: single-view depth estimation over HTTP (port of
``stereo_tpu/serve/api.py``: the stdlib server, ``MicroBatcher`` and the
ASGI 3 application ``create_asgi_app``).

``POST /`` takes a PNG of any colour type, bit depth or interlace, a JPEG
(baseline or progressive, grey, YCbCr, RGB or CMYK), a BMP, TIFF or GIF
(``_native/raster.cc``), a WebP (lossless, lossy, with alpha, an
animation's first frame: ``_native/webp.cc``) or a PNM or PFM
(``utils/pnm.py``), as a multipart
``file`` field or the raw body, runs the single-view pipeline (right-view
synthesis + the configured backend) and answers with the disparity map as
an 8-bit PNG; ``GET /`` returns the configuration.  Both surfaces share
``DepthEstimationServer.run_pipeline`` and the port's decoders
(``utils.image_io.decode_image_rgb``: the format the bytes' signature
names, to the RGB of PIL's ``convert("RGB")``, which the JAX server reads
uploads with; a PNG over PIL's decompression-bomb limit of 178956970
pixels is a 400, as PIL refuses it, before anything of its declared size
is allocated).  Uploads travel to the
device as uint8 and are upcast there; the disparity is quantised to uint8
on the device before it comes back.  Uploads at the pipeline shape go in
unresized; other sizes are resized on the device.
"""

from __future__ import annotations

import json
import queue
import re
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.config import MeshConfig, PipelineConfig
from ..core.device import resolve_device
from ..pipeline.depth_pipeline import DepthEstimationPipeline
from ..synthesis.right_view_synthesis import resize_nchw
from ..utils.image_io import decode_image_rgb
from ..utils.png import BadRequestError, encode_png


def decode_png_to_pipeline_image(data: bytes, image_shape,
                                 device) -> torch.Tensor:
    """Image bytes (PNG, JPEG, BMP, TIFF, GIF, WebP, PNM or PFM) ->
    (3, H, W) uint8 tensor on ``device`` at the pipeline shape.  The bytes
    are decoded on the host by ``utils.image_io.decode_image_rgb`` (the
    format their signature names) to the 8-bit RGB the JAX server's image
    library gives; the upload is uint8.  Another size is resized on the
    device (bilinear, antialiased) and rounded back to uint8, as an image
    library's resize would.  Other formats, the variants the port does not decode (named in
    the message) and files the decoders refuse are a ``BadRequestError``
    (400) naming the format and the cause."""
    arr = decode_image_rgb(data)
    chw = torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1)))
    chw = chw.to(device)
    if tuple(chw.shape[-2:]) != tuple(image_shape):
        resized = resize_nchw(chw[None].float(), image_shape)[0]
        chw = torch.clamp(torch.round(resized), 0, 255).to(torch.uint8)
    return chw


def device_upcast_f32(x_u8: torch.Tensor, device) -> torch.Tensor:
    """Move a uint8 tensor to ``device`` (one byte per pixel) and upcast it
    to float32 there."""
    return x_u8.to(device).to(torch.float32)


def quantize_disparity_u8(disparity: torch.Tensor) -> torch.Tensor:
    """Float disparity -> uint8 (round half to even, clip 0..255) on the
    disparity's device."""
    return torch.clamp(torch.round(disparity), 0, 255).to(torch.uint8)


def encode_disparity_png(disparity_hw: torch.Tensor) -> bytes:
    """(H, W) float disparity -> 8-bit grey PNG bytes."""
    return encode_png(quantize_disparity_u8(disparity_hw).cpu().numpy())


def _extract_multipart_file(body: bytes, content_type: str) -> Optional[bytes]:
    """Minimal multipart/form-data parser: the first file part."""
    match = re.search(r'boundary="?([^";]+)"?', content_type)
    if not match:
        return None
    boundary = b"--" + match.group(1).encode()
    # RFC 2046: each part ends at CRLF + boundary, so splitting on that
    # delimiter yields exact payloads.
    for part in body.split(b"\r\n" + boundary):
        header_end = part.find(b"\r\n\r\n")
        if header_end < 0 or b"filename=" not in part[:header_end]:
            continue
        return part[header_end + 4:]
    return None


class MicroBatcher:
    """Coalesces concurrent single-frame requests into device batches.

    Serving threads ``submit()`` a (3, H, W) uint8 device frame and block on
    its future.  A dispatch thread groups up to ``max_batch`` frames
    (waiting at most ``max_wait_ms`` after the first), pads the group to the
    fixed batch size, and enqueues upcast, ``pipeline.process_batch`` and
    the uint8 quantisation, which return before the device finishes.  A
    readback thread copies each group's result to the host (the only wait
    on the device) and resolves the futures, so one group's compute
    overlaps the previous group's copy.  ``depth`` bounds the groups in
    flight.
    """

    def __init__(self, pipeline: DepthEstimationPipeline, max_batch: int = 4,
                 max_wait_ms: float = 4.0, depth: int = 2):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._queue: "queue.Queue" = queue.Queue()
        self._inflight: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self.batches_run = 0
        self.frames_run = 0
        self._worker = threading.Thread(target=self._dispatch_loop,
                                        daemon=True)
        self._collector = threading.Thread(target=self._readback_loop,
                                           daemon=True)
        self._worker.start()
        self._collector.start()

    def submit(self, left_chw_u8: torch.Tensor) -> Future:
        future: Future = Future()
        self._queue.put((left_chw_u8, future))
        return future

    def _drain_group(self):
        # An idle batcher waits for its next request without a bound:
        # shutdown() posts None.
        item = self._queue.get()
        if item is None:
            return None
        group = [item]
        deadline = time.monotonic() + self.max_wait_s
        while len(group) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)   # re-post shutdown for the outer loop
                break
            group.append(nxt)
        return group

    def _dispatch_loop(self) -> None:
        while True:
            group = self._drain_group()
            if group is None:
                self._inflight.put(None)
                return
            try:
                lefts = torch.stack([left for left, _ in group])
                pad = self.max_batch - len(group)
                if pad:
                    lefts = torch.cat([lefts, lefts[-1:].expand(pad, -1, -1, -1)])
                result = self.pipeline.process_batch(
                    device_upcast_f32(lefts, self.pipeline.device), None)
                device_u8 = quantize_disparity_u8(result.disparity_map)
            except Exception as exc:  # noqa: BLE001 — propagate per request
                for _, future in group:
                    future.set_exception(exc)
                continue
            self._inflight.put((device_u8, group))   # blocks at depth limit

    def _readback_loop(self) -> None:
        while True:
            # The dispatcher posts every batch, and None when it stops.
            item = self._inflight.get()
            if item is None:
                return
            device_u8, group = item
            try:
                disparities = device_u8.cpu().numpy()
            except Exception as exc:  # noqa: BLE001 — propagate per request
                for _, future in group:
                    future.set_exception(exc)
                continue
            self.batches_run += 1
            self.frames_run += len(group)
            for i, (_, future) in enumerate(group):
                future.set_result(disparities[i])

    def shutdown(self) -> None:
        self._queue.put(None)
        self._worker.join(timeout=5)
        self._collector.join(timeout=5)


class DepthEstimationServer:
    """Owns the pipeline and the HTTP server.

    ``micro_batch > 1`` coalesces concurrent uploads into one device batch
    instead of serialising them on a lock.  Under a multi-device mesh a
    micro-batch must be a multiple of the mesh's batch group (data x disp),
    which every batch of the sharded engines must be.  ``start()`` serves
    from a daemon thread and ``shutdown()`` stops it; ``serve()`` blocks.
    """

    def __init__(self, config: PipelineConfig = PipelineConfig(),
                 pipeline: Optional[DepthEstimationPipeline] = None,
                 micro_batch: int = 1, device="cuda"):
        self.config = config
        mesh = config.mesh
        if (mesh is not None and mesh.num_devices > 1 and micro_batch > 1
                and micro_batch % (mesh.data * mesh.disp)):
            raise ValueError(f"micro_batch {micro_batch} is not a multiple "
                             f"of the mesh's batch group "
                             f"{mesh.data * mesh.disp} (data x disp)")
        self.pipeline = pipeline or DepthEstimationPipeline(config,
                                                            device=device)
        self.device = resolve_device(self.pipeline.device)
        self._lock = threading.Lock()
        self.batcher = (MicroBatcher(self.pipeline, max_batch=micro_batch)
                        if micro_batch > 1 else None)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def run_pipeline(self, png_bytes: bytes) -> bytes:
        left = decode_png_to_pipeline_image(png_bytes, self.config.image_shape,
                                            self.device)
        if self.batcher is not None:
            disparity = self.batcher.submit(left).result(timeout=120)
            return encode_png(disparity)
        with self._lock:
            result = self.pipeline.process(device_upcast_f32(left, self.device))
            return encode_disparity_png(result.disparity_map)

    def info(self) -> bytes:
        """The ``GET /`` reply: backend, image shape and device as JSON."""
        return json.dumps({
            "backend": self.config.stereo_matching_backend,
            "image_shape": list(self.config.image_shape),
            "device": str(self.device),
        }).encode()

    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, status: int, ctype: str, body: bytes) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    ctype = self.headers.get("Content-Type", "")
                    if ctype.startswith("multipart/form-data"):
                        payload = _extract_multipart_file(body, ctype)
                        if payload is None:
                            raise BadRequestError("no file field in upload")
                    else:
                        payload = body
                    png = server.run_pipeline(payload)
                except Exception as exc:  # noqa: BLE001 — report to client
                    status = 400 if isinstance(exc, BadRequestError) else 500
                    self._reply(status, "application/json",
                                json.dumps({"error": str(exc)}).encode())
                    return
                self._reply(200, "image/png", png)

            def do_GET(self):
                self._reply(200, "application/json", server.info())

            def log_message(self, fmt, *args):  # quiet
                pass

        return Handler

    def start(self, host: str = "127.0.0.1", port: int = 0) -> Tuple[str, int]:
        """Serve from a daemon thread; returns the bound ``(host, port)``
        (``port=0`` picks a free port)."""
        self._httpd = ThreadingHTTPServer((host, port), self.make_handler())
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._httpd.server_address[:2]

    def shutdown(self) -> None:
        """Stop the HTTP server, close its socket and stop the batcher."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5)
            self._httpd = None
        if self.batcher is not None:
            self.batcher.shutdown()

    def serve(self, host: str = "localhost", port: int = 8080) -> None:
        """Serve in the calling thread until interrupted."""
        bound = self.start(host, port)
        print(f"Serving depth estimation on http://{bound[0]}:{bound[1]}")
        try:
            self._thread.join()     # serving until interrupted, by design
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()


def create_asgi_app(config: PipelineConfig = PipelineConfig(),
                    pipeline: Optional[DepthEstimationPipeline] = None,
                    micro_batch: int = 1, device="cuda"):
    """An ASGI 3 application with the HTTP server's contract: ``POST /``
    with a PNG (multipart ``file`` field or raw body) -> disparity PNG,
    ``GET /`` -> configuration JSON; 400 for a bad payload, 405 for another
    method, 500 for a fault of the server.  Any ASGI server (uvicorn,
    hypercorn) can mount it.  The pipeline runs in the event loop's
    default executor, so device work never blocks the loop."""
    import asyncio

    server = DepthEstimationServer(config, pipeline=pipeline,
                                   micro_batch=micro_batch, device=device)

    async def read_body(receive) -> bytes:
        chunks = []
        while True:
            message = await receive()
            chunks.append(message.get("body", b""))
            if not message.get("more_body"):
                return b"".join(chunks)

    async def respond(send, status: int, content_type: bytes, body: bytes):
        await send({"type": "http.response.start", "status": status,
                    "headers": [(b"content-type", content_type),
                                (b"content-length",
                                 str(len(body)).encode())]})
        await send({"type": "http.response.body", "body": body})

    async def app(scope, receive, send):
        if scope["type"] != "http":
            raise RuntimeError(f"unsupported scope type {scope['type']!r}")
        if scope["method"] == "GET":
            await respond(send, 200, b"application/json", server.info())
            return
        if scope["method"] != "POST":
            await respond(send, 405, b"application/json",
                          b'{"error": "POST a PNG to /"}')
            return
        try:
            body = await read_body(receive)
            ctype = dict(scope.get("headers") or {}).get(
                b"content-type", b"").decode()
            if ctype.startswith("multipart/form-data"):
                payload = _extract_multipart_file(body, ctype)
                if payload is None:
                    raise BadRequestError("no file field in upload")
            else:
                payload = body
            loop = asyncio.get_running_loop()
            png = await loop.run_in_executor(None, server.run_pipeline,
                                             payload)
        except Exception as exc:  # noqa: BLE001 — report to client
            status = 400 if isinstance(exc, BadRequestError) else 500
            await respond(send, status, b"application/json",
                          json.dumps({"error": str(exc)}).encode())
            return
        await respond(send, 200, b"image/png", png)

    return app


def parse_args(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Depth estimation REST API")
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--backend", default="classical",
                        choices=["classical", "gwcnet", "msnet2d", "msnet3d"])
    parser.add_argument("--height", type=int, default=384)
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--max-disparity", type=int, default=64)
    parser.add_argument("--micro-batch", type=int, default=1,
                        help=">1 coalesces concurrent requests into device "
                             "batches")
    parser.add_argument("--compute-dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="precision of the neural paths (DNN backend and "
                             "right-view synthesis)")
    parser.add_argument("--mesh", default=None, metavar="DATA,TILE,DISP",
                        help="serve through the mesh-sharded engines, e.g. "
                             "'2,2,1'; needs data*tile*disp cards with "
                             "--device cuda (with --device cpu the mesh's "
                             "devices are the CPU)")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def config_from_args(args) -> PipelineConfig:
    mesh = None
    if args.mesh:
        data, tile, disp = (int(v) for v in args.mesh.split(","))
        mesh = MeshConfig(data=data, tile=tile, disp=disp)
    return PipelineConfig(image_shape=(args.height, args.width),
                          min_disparity=0, max_disparity=args.max_disparity,
                          stereo_matching_backend=args.backend,
                          compute_dtype=args.compute_dtype, mesh=mesh)


def main(argv=None) -> None:
    args = parse_args(argv)
    DepthEstimationServer(config_from_args(args), micro_batch=args.micro_batch,
                          device=args.device).serve(args.host, args.port)


if __name__ == "__main__":
    main()
