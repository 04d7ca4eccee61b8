"""Minimal asyncio MQTT 3.1.1 client (QoS 0 publisher).

The reference publishes telemetry through the gmqtt package
(deepdish.py:64,643-680) — not available in this image, so this is a small
native implementation of the protocol subset the pipeline needs: CONNECT
with optional username/password, CONNACK wait, QoS-0 PUBLISH, PINGREQ
keepalive, and auto-reconnect with the reference's policy
(reconnect_retries=10, reconnect_delay=1; deepdish.py:675).

A copy of deepdish_tpu/pipeline/mqtt.py (host code; the port keeps its
own).
"""
from __future__ import annotations

import asyncio
import struct
from typing import Optional


def _encode_remaining_length(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n % 128
        n //= 128
        if n > 0:
            byte |= 0x80
        out.append(byte)
        if n == 0:
            return bytes(out)


def _encode_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">H", len(b)) + b


class MQTTClient:
    """Tiny MQTT 3.1.1 publisher."""

    def __init__(self, client_id: str, host: str, port: int = 1883,
                 username: Optional[str] = None,
                 password: Optional[str] = None,
                 keepalive: int = 60,
                 reconnect_retries: int = 10, reconnect_delay: float = 1.0):
        self.client_id = client_id or "deepdish-tpu"
        self.host, self.port = host, port
        self.username, self.password = username, password
        self.keepalive = keepalive
        self.reconnect_retries = reconnect_retries
        self.reconnect_delay = reconnect_delay
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._ping_task: Optional[asyncio.Task] = None
        self.connected = asyncio.Event()

    async def connect(self):
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        flags = 0x02  # clean session
        payload = _encode_str(self.client_id)
        if self.username is not None:
            flags |= 0x80
            payload += _encode_str(self.username)
            if self.password is not None:
                flags |= 0x40
                payload += _encode_str(self.password)
        var = (_encode_str("MQTT") + bytes([0x04, flags]) +
               struct.pack(">H", self.keepalive))
        pkt = bytes([0x10]) + _encode_remaining_length(
            len(var) + len(payload)) + var + payload
        self._writer.write(pkt)
        await self._writer.drain()
        # CONNACK: 0x20 0x02 <flags> <rc>
        hdr = await asyncio.wait_for(self._reader.readexactly(4), timeout=10)
        if hdr[0] != 0x20 or hdr[3] != 0x00:
            raise ConnectionError(f"MQTT CONNACK refused: rc={hdr[3]}")
        self.connected.set()
        self._ping_task = asyncio.ensure_future(self._ping_loop())

    async def _ping_loop(self):
        try:
            while True:
                await asyncio.sleep(max(self.keepalive // 2, 5))
                if self._writer is None:
                    return
                self._writer.write(bytes([0xC0, 0x00]))  # PINGREQ
                await self._writer.drain()
        except (ConnectionError, asyncio.CancelledError, OSError):
            pass

    def publish(self, topic: str, payload, qos: int = 0):
        """QoS-0 publish; schedules the write (gmqtt-compatible call shape)."""
        if self._writer is None:
            return
        if isinstance(payload, str):
            payload = payload.encode("utf-8")
        var = _encode_str(topic)
        pkt = bytes([0x30]) + _encode_remaining_length(
            len(var) + len(payload)) + var + payload
        try:
            self._writer.write(pkt)
        except (ConnectionError, OSError):
            self.connected.clear()
            asyncio.ensure_future(self._reconnect())

    async def _reconnect(self):
        for _ in range(self.reconnect_retries):
            try:
                await self.connect()
                return
            except (ConnectionError, OSError):
                await asyncio.sleep(self.reconnect_delay)

    async def disconnect(self):
        if self._ping_task:
            self._ping_task.cancel()
        if self._writer is not None:
            try:
                self._writer.write(bytes([0xE0, 0x00]))  # DISCONNECT
                await self._writer.drain()
                self._writer.close()
            except (ConnectionError, OSError):
                pass
        self.connected.clear()
