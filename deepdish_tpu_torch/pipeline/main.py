"""The port's CLI: `python -m deepdish_tpu_torch.pipeline.main --input ...`
(installed as `deepdish-tpu-torch`).

Port of deepdish_tpu/pipeline/main.py, the reference's startup path
(deepdish.py:1508-1582): builds the Pipeline, connects MQTT, starts the UDP
command console, installs signal handlers and the loop exception handler,
and runs the stages plus the periodic heartbeat until the video ends or a
signal arrives. The device is CUDA unless `--device cpu` (or
`--disable-edgetpu`) is given; without a card the CUDA default raises.
"""
from __future__ import annotations

import asyncio
import signal
import traceback

from .config import get_arguments
from .runtime import Pipeline


class CommandServer(asyncio.DatagramProtocol):
    """Echo-only UDP control console (deepdish.py:1508-1522)."""

    def __init__(self, pipeline):
        self.pipeline = pipeline

    def connection_made(self, transport):
        self.transport = transport

    def datagram_received(self, data, addr):
        self.transport.sendto(data, addr)


async def amain(argv=None):
    args = get_arguments(argv)
    pipeline = Pipeline(args)
    loop = asyncio.get_event_loop()

    await pipeline.init_mqtt()

    cmdserver = None
    if args.control_port:
        try:
            cmdserver, _ = await loop.create_datagram_endpoint(
                lambda: CommandServer(pipeline),
                local_addr=('0.0.0.0', args.control_port))
        except OSError as e:
            print(f'Command server disabled: {e}')

    def on_signal():
        pipeline.running = False
        pipeline.final_frame = pipeline.frame_count

    for sig in (signal.SIGHUP, signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, on_signal)
        except (NotImplementedError, RuntimeError):
            pass

    def handle_exception(loop, context):
        e = context.get('exception')
        if e is not None:
            traceback.print_exception(type(e), e, e.__traceback__)
        else:
            print(context.get('message'))
        pipeline.running = False
        pipeline.final_frame = pipeline.frame_count

    loop.set_exception_handler(handle_exception)

    hb = asyncio.ensure_future(pipeline.periodic_heartbeat())
    try:
        await pipeline.start()
    finally:
        hb.cancel()
        if cmdserver is not None:
            cmdserver.close()
        if pipeline.webserver is not None:
            await pipeline.webserver.stop()
        if pipeline.mqtt is not None:
            await pipeline.mqtt.disconnect()


def main(argv=None):
    try:
        asyncio.run(amain(argv))
    except KeyboardInterrupt:
        pass


if __name__ == '__main__':
    main()
