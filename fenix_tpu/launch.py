"""CLI entry point: ``python -m fenix_tpu.launch <root> [--host] [--port]``.

Parity: /root/reference/src/fenix/launch.py:12-21 (typer CLI wrapping
Server.serve). argparse here — typer is not in the runtime environment.
"""

from __future__ import annotations

import argparse
import logging

from fenix_tpu.flight import Server
from fenix_tpu.utils.jax_cache import configure_compile_cache

logging.basicConfig()
LOGGER = logging.getLogger("fenix_tpu")
LOGGER.setLevel(logging.INFO)


def launch(root: str, host: str = "0.0.0.0", port: int = 9001) -> None:
    server = Server(root, host, port)
    LOGGER.info(f"Server started at {server.grpc}")
    server.serve()


def main() -> None:
    parser = argparse.ArgumentParser(description="fenix_tpu Flight server")
    parser.add_argument("root", help="storage root directory")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=9001)
    args = parser.parse_args()
    configure_compile_cache()
    launch(args.root, args.host, args.port)


if __name__ == "__main__":
    main()
