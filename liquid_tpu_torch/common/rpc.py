"""Wire messages between compute clients and the cache server, and the
length-prefixed frames they travel in (host copy of
`liquid_tpu/common/rpc.py:1-129`).

The messages are the reference's Flight protocol (liquid-cache
`src/common/src/rpc.rs:14-242`): `RegisterObjectStoreRequest`,
`RegisterPlanRequest{plan, handle, tables}`, `PrefetchRequest`,
`FetchResults{handle, partition, traceparent}` (the DoGet ticket) and
`ExecutionMetricsResponse{pushdown_eval_time, cache_memory_usage,
liquid_cache_usage}`.  The Flight service (`server/flight.py`) carries
them as JSON bodies; the frames below carry them over a plain socket:
1-byte kind ('J' json | 'A' arrow | 'E' error | 'Z' end) + 4-byte LE
length + payload, each arrow frame a self-contained IPC stream
(dictionaries resent with every batch).
"""
from __future__ import annotations

import io
import json
import socket
import struct
from dataclasses import asdict, dataclass, field
from typing import Iterator, Optional

import pyarrow as pa

KIND_JSON = b"J"
KIND_ARROW = b"A"
KIND_ERROR = b"E"
KIND_END = b"Z"

#: the start of the error a fetch or a metrics call meets on a plan
#: handle the server does not hold (one registered before a reset)
UNKNOWN_HANDLE = "unknown plan handle"


# -- messages (ref rpc.rs prost structs) ------------------------------------

@dataclass
class RegisterObjectStoreRequest:
    url: str                       # e.g. "mock://bucket" | "file:///"
    options: dict = field(default_factory=dict)


@dataclass
class RegisterPlanRequest:
    plan: str                      # SQL text (our plan-shipping format)
    handle: str                    # UUID chosen by the client
    tables: dict = field(default_factory=dict)  # name -> object path/url


@dataclass
class PrefetchRequest:
    url: str
    location: str
    range: Optional[list] = None   # [start, end) or None = whole object


@dataclass
class FetchResults:
    handle: str
    partition: int
    traceparent: str = ""          # W3C trace context (ref rpc.rs:203)


@dataclass
class ExecutionMetricsResponse:
    pushdown_eval_time: int = 0    # ms (ref rpc.rs:228)
    cache_memory_usage: int = 0
    liquid_cache_usage: int = 0


# -- framing -----------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def write_msg(sock: socket.socket, kind: bytes, payload: bytes) -> None:
    sock.sendall(kind + struct.pack("<I", len(payload)) + payload)


def read_msg(sock: socket.socket):
    head = _recv_exact(sock, 5)
    kind = head[:1]
    (length,) = struct.unpack("<I", head[1:])
    return kind, _recv_exact(sock, length)


def write_json(sock: socket.socket, obj) -> None:
    if hasattr(obj, "__dataclass_fields__"):
        obj = asdict(obj)
    write_msg(sock, KIND_JSON, json.dumps(obj).encode())


def read_json(sock: socket.socket) -> dict:
    kind, payload = read_msg(sock)
    if kind == KIND_ERROR:
        raise RuntimeError(payload.decode())
    assert kind == KIND_JSON, kind
    return json.loads(payload)


def write_table_stream(sock: socket.socket, table: pa.Table,
                       batch_rows: int = 8192) -> None:
    """Stream a table as arrow IPC batches (dictionary resend semantics:
    each frame is a self-contained IPC stream, ref lib.rs:222-234)."""
    for batch in table.to_batches(max_chunksize=batch_rows):
        sink = io.BytesIO()
        with pa.ipc.new_stream(sink, batch.schema) as w:
            w.write_batch(batch)
        write_msg(sock, KIND_ARROW, sink.getvalue())
    write_msg(sock, KIND_END, b"")


def read_table_stream(sock: socket.socket) -> Iterator[pa.RecordBatch]:
    while True:
        kind, payload = read_msg(sock)
        if kind == KIND_END:
            return
        if kind == KIND_ERROR:
            raise RuntimeError(payload.decode())
        assert kind == KIND_ARROW, kind
        with pa.ipc.open_stream(io.BytesIO(payload)) as r:
            for batch in r:
                yield batch
