"""MJPEG web streamer over raw asyncio (replacing Quart + hypercorn).

Serves `GET /` as a `multipart/x-mixed-replace` JPEG stream exactly like the
reference webapp (deepdish.py:138-187): an async-lock frame box
(StreamingInfo), a 3 ms cooperative polling loop per client, and cv2 JPEG
encoding. Implemented directly on asyncio.start_server because the Quart
stack is not in this image — and a ~100-line server is all the capability
the reference actually uses.

A copy of deepdish_tpu/pipeline/mjpeg.py (host code; the port keeps its
own), with cv2 imported only where a frame is encoded.
"""
from __future__ import annotations

import asyncio
from typing import Optional

import numpy as np


class StreamingInfo:
    """Concurrency-safe frame box (deepdish.py:141-151)."""

    def __init__(self):
        self.lock = asyncio.Lock()
        self.frame: Optional[np.ndarray] = None

    async def get_frame(self):
        async with self.lock:
            return self.frame

    async def set_frame(self, frame):
        async with self.lock:
            self.frame = frame


class MJPEGServer:
    def __init__(self, streaminfo: StreamingInfo, port: int = 8080,
                 host: str = "0.0.0.0"):
        self.si = streaminfo
        self.port = port
        self.host = host
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self):
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)

    async def stop(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        try:
            request = await asyncio.wait_for(reader.readline(), timeout=10)
            while True:  # drain headers
                line = await asyncio.wait_for(reader.readline(), timeout=10)
                if line in (b"\r\n", b"\n", b""):
                    break
            path = request.split(b" ")[1] if len(request.split(b" ")) > 1 \
                else b"/"
            if path not in (b"/", b""):
                writer.write(b"HTTP/1.1 404 Not Found\r\n"
                             b"Content-Length: 0\r\n\r\n")
                await writer.drain()
                writer.close()
                return
            writer.write(
                b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: multipart/x-mixed-replace; "
                b"boundary=frame\r\n"
                b"Cache-Control: no-cache\r\n\r\n")
            await writer.drain()
            while True:
                await asyncio.sleep(0.003)  # cooperate (deepdish.py:158)
                frame = await self.si.get_frame()
                if frame is None:
                    continue
                import cv2
                flag, encoded = cv2.imencode(".jpg", frame)
                if not flag:
                    continue
                writer.write(b"--frame\r\n"
                             b"Content-Type: image/jpeg\r\n\r\n" +
                             bytearray(encoded) + b"\r\n")
                await writer.drain()
        except (ConnectionError, asyncio.TimeoutError, OSError,
                asyncio.CancelledError, IndexError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass
