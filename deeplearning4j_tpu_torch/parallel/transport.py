"""Socket transport for cross-process encoded-gradient exchange.

Counterpart of the JAX package's `parallel/transport.py`, with the same
``DTPU`` wire frame byte for byte, so a port process and a reference
process exchange messages. Parity target: the reference's Aeron UDP mesh — `VoidParameterServer` init at
`spark/dl4j-spark-parameterserver/.../pw/SharedTrainingWrapper.java:206-244`
and the peer-to-peer update multicast of
`networking/WiredEncodingHandler.java:20-89`. Every worker broadcasts its
threshold-encoded update message to all peers and applies the identical sum,
so replicas stay in lockstep without parameter broadcast.

Within a node, gradients ride the process group's all-reduce
(`parallel/plan.py`); this transport is the host-side path between
nodes, where the sparse 3-array message (indices, payload, scalar)
crosses TCP instead of Aeron UDP. TCP is deliberate: the reference's own comment
("pray for udp broadcast availability", WiredEncodingHandler.java:89)
documents exactly the delivery problem TCP removes.

Wire format per message:
    MAGIC (4B) | n_idx uint32 | payload_kind uint8 (0=int8 signs, 1=f32
    values) | scalar float32 | idx int32[n] | payload bytes
"""
from __future__ import annotations

import queue
import random
import socket
import struct
import threading
import time
from typing import List, Tuple

import numpy as np

from deeplearning4j_tpu_torch import monitor

_MAGIC = b"DTPU"
_HEADER = struct.Struct("<4sIBf")


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):            # a torch tensor, on any device
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _encode_message(message: Tuple) -> bytes:
    idx, payload, scalar = message
    idx = _host(idx).astype(np.int32)
    payload = _host(payload)
    kind = 0 if payload.dtype == np.int8 else 1
    payload = payload.astype(np.int8 if kind == 0 else np.float32)
    head = _HEADER.pack(_MAGIC, idx.size, kind, float(scalar))
    return head + idx.tobytes() + payload.tobytes()


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return buf


def _decode_message(sock: socket.socket) -> Tuple:
    head = _read_exact(sock, _HEADER.size)
    magic, n_idx, kind, scalar = _HEADER.unpack(head)
    if magic != _MAGIC:
        raise ValueError(f"bad magic {magic!r}")
    idx = np.frombuffer(_read_exact(sock, n_idx * 4), np.int32)
    if kind == 0:
        payload = np.frombuffer(_read_exact(sock, n_idx), np.int8)
    else:
        payload = np.frombuffer(_read_exact(sock, n_idx * 4), np.float32)
    return idx, payload, scalar


class SocketTransport:
    """Full-mesh TCP transport: one instance per OS process (= one logical
    pod). `broadcast` sends the message to every peer; `recv` blocks until
    the expected number of peer messages arrive.

    Messages go out as numpy arrays (tensors on any device are copied
    to the host first) and arrive as numpy arrays.

    Ports: peer r listens on ``base_port + r``. Outbound connections are
    established lazily on first broadcast (with retry, so start order
    doesn't matter — the Aeron mesh's introduction handshake analog,
    SilentIntroductoryMessage).
    """

    #: backoff shape for _connect's retry loop (floor doubles up to cap,
    #: each sleep jittered into [0.5x, 1.5x])
    CONNECT_BACKOFF_FLOOR = 0.02
    CONNECT_BACKOFF_CAP = 1.0

    def __init__(self, rank: int, n_workers: int, base_port: int = 29610,
                 host: str = "127.0.0.1", connect_timeout: float = 30.0):
        self.rank = rank
        self.n_workers = n_workers
        self.host = host
        self.base_port = base_port
        self.connect_timeout = connect_timeout
        self.messages_sent = 0
        self.bytes_sent = 0
        #: optional fault hook (util/faults.attach_transport_faults):
        #: called with the peer rank per outbound message; False = drop
        self.send_filter = None
        self._inbox: "queue.Queue[Tuple]" = queue.Queue()
        self._out: dict = {}
        self._lock = threading.Lock()
        # deterministic backoff jitter stream, decorrelated across ranks
        self._jitter = random.Random(0x5EED ^ rank)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, base_port + rank))
        self._listener.listen(n_workers)
        self._closed = False
        self._close_lock = threading.Lock()
        self._inbound: set = set()
        self._inbound_lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"transport-accept-r{rank}")
        self._accept_thread.start()

    # ------------------------------------------------------------- receive
    def _accept_loop(self):
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            with self._inbound_lock:
                if self._closed:
                    conn.close()
                    return
                self._inbound.add(conn)
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True,
                             name=f"transport-reader-r{self.rank}").start()

    def _reader(self, conn: socket.socket):
        try:
            while not self._closed:
                msg = _decode_message(conn)
                monitor.counter("transport_messages_received_total",
                                "Encoded-gradient messages received",
                                labels=("rank",)).inc(rank=self.rank)
                monitor.counter(
                    "transport_bytes_received_total",
                    "Wire bytes received (header + indices + payload)",
                    labels=("rank",)).inc(
                    _HEADER.size + msg[0].nbytes + msg[1].nbytes,
                    rank=self.rank)
                self._inbox.put(msg)
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            with self._inbound_lock:
                self._inbound.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def recv(self, n_messages: int, timeout: float = 120.0) -> List[Tuple]:
        """Block until `n_messages` peer messages arrive (one iteration's
        worth in lockstep training)."""
        out = []
        t0 = time.perf_counter()
        deadline = time.monotonic() + timeout
        with monitor.span("transport/recv", rank=self.rank,
                          n_messages=n_messages):
            while len(out) < n_messages:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    monitor.counter("transport_recv_timeouts_total",
                                    "recv() deadline expiries",
                                    labels=("rank",)).inc(rank=self.rank)
                    raise TimeoutError(
                        f"rank {self.rank}: got {len(out)}/{n_messages} "
                        f"messages")
                try:
                    out.append(self._inbox.get(timeout=min(remaining, 1.0)))
                except queue.Empty:
                    continue
        monitor.histogram("transport_recv_wait_seconds",
                          "Blocking wait for one iteration's peer messages",
                          labels=("rank",)).observe(
            time.perf_counter() - t0, rank=self.rank)
        return out

    # ---------------------------------------------------------------- send
    def _connect(self, peer: int) -> socket.socket:
        """Connect to a peer with jittered exponential backoff under a
        bounded total deadline (`connect_timeout`). Start order between
        workers doesn't matter (the Aeron-mesh introduction handshake
        analog); an unreachable peer fails with an error naming exactly
        who could not be reached."""
        addr = (self.host, self.base_port + peer)
        deadline = time.monotonic() + self.connect_timeout
        delay = self.CONNECT_BACKOFF_FLOOR
        last_err = None
        attempts = 0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ConnectionError(
                    f"rank {self.rank} could not reach peer {peer} at "
                    f"{addr[0]}:{addr[1]} after {attempts} attempts over "
                    f"{self.connect_timeout:.1f}s: {last_err}")
            try:
                s = socket.create_connection(
                    addr, timeout=min(2.0, max(remaining, 0.1)))
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                monitor.counter("transport_connects_total",
                                "Outbound peer connections established",
                                labels=("rank",)).inc(rank=self.rank)
                return s
            except OSError as e:       # peer not up yet — back off, retry
                last_err = e
                attempts += 1
                monitor.counter("transport_connect_retries_total",
                                "Failed connect attempts (peer not up yet "
                                "/ unreachable)",
                                labels=("rank",)).inc(rank=self.rank)
                sleep = min(delay * (0.5 + self._jitter.random()),
                            max(deadline - time.monotonic(), 0.0))
                if sleep > 0:
                    time.sleep(sleep)
                delay = min(delay * 2, self.CONNECT_BACKOFF_CAP)

    def broadcast(self, sender: int, message: Tuple):
        if self._closed:
            raise RuntimeError(
                f"rank {self.rank}: broadcast on a closed transport")
        data = _encode_message(message)
        t0 = time.perf_counter()
        with self._lock, monitor.span("transport/broadcast",
                                      rank=self.rank, bytes=len(data)):
            for peer in range(self.n_workers):
                if peer == self.rank:
                    continue
                if self.send_filter is not None \
                        and not self.send_filter(peer):
                    # injected message drop (util/faults)
                    monitor.counter("transport_messages_dropped_total",
                                    "Outbound messages dropped by the "
                                    "send filter (fault injection)",
                                    labels=("rank",)).inc(rank=self.rank)
                    continue
                if peer not in self._out:
                    # graftlint: disable=transitive-blocking-under-lock -- lazy reconnect under the serialize-writes lock is deadline-bounded (_connect's jittered backoff has a hard connect deadline); connecting outside it would let a racing send interleave wire frames on the fresh socket
                    self._out[peer] = self._connect(peer)
                # graftlint: disable=blocking-under-lock -- serializing frame writes on the shared socket IS this lock's purpose — concurrent sendall would interleave wire frames; sends are bounded by the socket timeout
                self._out[peer].sendall(data)
                self.messages_sent += 1
                self.bytes_sent += len(data)
                monitor.counter("transport_messages_sent_total",
                                "Encoded-gradient messages sent",
                                labels=("rank",)).inc(rank=self.rank)
                monitor.counter("transport_bytes_sent_total",
                                "Wire bytes sent",
                                labels=("rank",)).inc(len(data),
                                                      rank=self.rank)
        monitor.histogram("transport_send_seconds",
                          "broadcast() wall time (all peers, incl. lazy "
                          "connect)", labels=("rank",)).observe(
            time.perf_counter() - t0, rank=self.rank)

    def close(self):
        """Idempotent and safe to call concurrently with the accept/reader
        threads (or a second close): the first caller flips `_closed` under
        its own lock, later callers return immediately; closing the inbound
        sockets unblocks any reader mid-recv."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._inbound_lock:
            inbound = list(self._inbound)
            self._inbound.clear()
        for c in inbound:              # unblock readers stuck in recv
            try:
                c.close()
            except OSError:
                pass
        with self._lock:
            for s in self._out.values():
                try:
                    s.close()
                except OSError:
                    pass
            self._out.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
