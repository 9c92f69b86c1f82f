"""Stats storage — the pub/sub layer decoupling stats producers from UIs.

Parity: DL4J's storage abstraction
(`deeplearning4j-core/.../api/storage/StatsStorage.java` + `StatsStorageRouter`,
`Persistable`), with the two standard backends
(`deeplearning4j-ui-model/.../storage/InMemoryStatsStorage.java:20`,
`FileStatsStorage.java:15` — MapDB there, append-only JSONL here).

The port's copy of the JAX package's `ui/storage.py` (no framework in it).

Records are keyed (session_id, type_id, worker_id, timestamp) exactly like
the reference's Persistable contract; static info and updates are separate
spaces (putStaticInfo vs putUpdate). Listeners receive StatsStorageEvent-
style callbacks (NewSessionID/NewTypeID/NewWorkerID/PostUpdate/PostStatic).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class StatsRecord:
    """One persistable record (DL4J api/storage/Persistable)."""
    session_id: str
    type_id: str
    worker_id: str
    timestamp: float
    data: Dict[str, Any]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "StatsRecord":
        return StatsRecord(**json.loads(s))


class StatsStorageRouter:
    """Write-side API (DL4J StatsStorageRouter) — what listeners see."""

    def put_static_info(self, record: StatsRecord):
        raise NotImplementedError

    def put_update(self, record: StatsRecord):
        raise NotImplementedError


class StatsStorage(StatsStorageRouter):
    """Readable storage + pub/sub (DL4J StatsStorage).

    Query API mirrors the reference: listSessionIDs,
    getAllUpdatesAfter, getLatestUpdate, getStaticInfo...
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._static: Dict[Tuple[str, str, str], StatsRecord] = {}
        self._updates: Dict[Tuple[str, str, str], List[StatsRecord]] = {}
        self._listeners: List[Callable[[str, StatsRecord], None]] = []

    # ------------------------------------------------------------- write
    def put_static_info(self, record: StatsRecord):
        key = (record.session_id, record.type_id, record.worker_id)
        with self._lock:
            is_new_session = not any(
                k[0] == record.session_id
                for k in list(self._static) + list(self._updates))
            self._static[key] = record
            self._persist("static", record)
        if is_new_session:
            self._emit("new_session", record)
        self._emit("post_static", record)

    def put_update(self, record: StatsRecord):
        key = (record.session_id, record.type_id, record.worker_id)
        with self._lock:
            is_new_session = not any(
                k[0] == record.session_id
                for k in list(self._static) + list(self._updates))
            self._updates.setdefault(key, []).append(record)
            self._persist("update", record)
        if is_new_session:
            self._emit("new_session", record)
        self._emit("post_update", record)

    # -------------------------------------------------------------- read
    def list_session_ids(self) -> List[str]:
        with self._lock:
            return sorted({k[0] for k in
                           list(self._static) + list(self._updates)})

    def list_type_ids(self, session_id: str) -> List[str]:
        with self._lock:
            return sorted({k[1] for k in
                           list(self._static) + list(self._updates)
                           if k[0] == session_id})

    def list_worker_ids(self, session_id: str) -> List[str]:
        with self._lock:
            return sorted({k[2] for k in
                           list(self._static) + list(self._updates)
                           if k[0] == session_id})

    def get_static_info(self, session_id: str, type_id: str,
                        worker_id: str) -> Optional[StatsRecord]:
        with self._lock:
            return self._static.get((session_id, type_id, worker_id))

    def get_all_updates_after(self, session_id: str, type_id: str,
                              worker_id: str,
                              timestamp: float) -> List[StatsRecord]:
        with self._lock:
            recs = self._updates.get((session_id, type_id, worker_id), [])
            return [r for r in recs if r.timestamp > timestamp]

    def get_latest_update(self, session_id: str, type_id: str,
                          worker_id: str) -> Optional[StatsRecord]:
        with self._lock:
            recs = self._updates.get((session_id, type_id, worker_id), [])
            return recs[-1] if recs else None

    def num_updates(self, session_id: str, type_id: str,
                    worker_id: str) -> int:
        with self._lock:
            return len(self._updates.get((session_id, type_id, worker_id), []))

    # ------------------------------------------------------------ pub/sub
    def register_stats_storage_listener(
            self, fn: Callable[[str, StatsRecord], None]):
        """fn(event, record); event in {new_session, post_static,
        post_update} (DL4J StatsStorageListener events)."""
        self._listeners.append(fn)

    def deregister_stats_storage_listener(self, fn):
        if fn in self._listeners:
            self._listeners.remove(fn)

    def _emit(self, event: str, record: StatsRecord):
        for fn in list(self._listeners):
            try:
                fn(event, record)
            except Exception:       # listener errors never break training
                pass

    # --------------------------------------------------------- persistence
    def _persist(self, kind: str, record: StatsRecord):
        pass                        # in-memory backend: no-op

    def close(self):
        pass


class InMemoryStatsStorage(StatsStorage):
    """Pure in-memory backend (InMemoryStatsStorage.java:20)."""


class FileStatsStorage(StatsStorage):
    """File-backed storage: append-only JSONL, reloaded on open
    (FileStatsStorage.java:15 — MapDB there; JSONL keeps it dependency-free
    and makes records greppable)."""

    def __init__(self, path: str):
        super().__init__()
        self._path = path
        self._file = None
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    entry = json.loads(line)
                    rec = StatsRecord(**entry["record"])
                    key = (rec.session_id, rec.type_id, rec.worker_id)
                    if entry["kind"] == "static":
                        self._static[key] = rec
                    else:
                        self._updates.setdefault(key, []).append(rec)
        self._file = open(path, "a")

    def _persist(self, kind: str, record: StatsRecord):
        if self._file is None:      # during __init__ replay
            return
        self._file.write(json.dumps(
            {"kind": kind, "record": dataclasses.asdict(record)},
            sort_keys=True) + "\n")
        self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


def new_session_id(prefix: str = "train") -> str:
    return f"{prefix}-{int(time.time() * 1000):x}-{os.getpid()}"


class RemoteUIStatsStorageRouter(StatsStorageRouter):
    """Streams StatsRecords to a remote UIServer over HTTP, so N worker
    processes/hosts feed ONE live dashboard.

    Parity: `api/storage/impl/RemoteUIStatsStorageRouter.java` (async
    queue + posting thread, exponential-backoff retries, shutdown after
    `max_retries` consecutive failures) posting to the receiver route the
    reference serves at POST /remoteReceive
    (`deeplearning4j-play/.../remote/RemoteReceiverModule.java:60`).
    Records batch per drain: one POST carries everything queued since the
    last one, so high-frequency listeners don't serialize on HTTP RTTs.

    Usage on a worker (any process/host that can reach the dashboard):
        router = RemoteUIStatsStorageRouter("http://dashboard:9000")
        net.set_listeners(StatsListener(router))
    and on the dashboard process (bind 0.0.0.0 when workers live on
    OTHER hosts; the default loopback bind only serves same-host workers):
        UIServer(port=9000, host="0.0.0.0").enable_remote_listener()
    """

    def __init__(self, address: str, max_retries: int = 10,
                 retry_delay_ms: int = 1000,
                 retry_backoff_factor: float = 2.0,
                 path: str = "/remoteReceive"):
        import queue as _queue
        self.url = address.rstrip("/") + path
        self.max_retries = max_retries
        self.retry_delay = retry_delay_ms / 1000.0
        self.backoff = retry_backoff_factor
        self._q: "_queue.Queue" = _queue.Queue()
        self._shutdown = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="RemoteStatsRouter")
        self._thread.start()

    # -- StatsStorageRouter write API -----------------------------------
    def put_static_info(self, record: StatsRecord):
        self._enqueue("static", record)

    def put_update(self, record: StatsRecord):
        self._enqueue("update", record)

    def _enqueue(self, kind: str, record: StatsRecord):
        if self._shutdown.is_set():
            import logging
            logging.getLogger("deeplearning4j_tpu_torch").warning(
                "RemoteUIStatsStorageRouter is shut down (too many "
                "consecutive post failures); dropping record")
            return
        self._idle.clear()
        self._q.put((kind, record))

    # -- posting thread ---------------------------------------------------
    def _drain(self):
        batch = []
        try:
            while True:
                batch.append(self._q.get_nowait())
        except Exception:
            pass
        return batch

    def _post(self, batch) -> bool:
        import urllib.request
        body = json.dumps({"records": [
            {"kind": kind, **dataclasses.asdict(rec)}
            for kind, rec in batch]}).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            return 200 <= resp.status < 300

    def _run(self):
        while not self._shutdown.is_set():
            if self._q.empty():
                self._idle.set()
                time.sleep(0.05)
                continue
            batch = self._drain()
            delay = self.retry_delay
            for attempt in range(self.max_retries + 1):
                try:
                    if self._post(batch):
                        break
                except Exception:
                    pass
                if attempt == self.max_retries:
                    # a batch that exhausted every retry shuts the router
                    # down, like the reference's repeated-failure shutdown —
                    # later records are dropped with a warning, training is
                    # never blocked on a dead dashboard
                    self._shutdown.set()
                    self._idle.set()
                    return
                # interruptible backoff: close() must not wait out the
                # exponential retry schedule
                if self._shutdown.wait(delay):
                    self._idle.set()
                    return
                delay *= self.backoff
        self._idle.set()

    # -- lifecycle --------------------------------------------------------
    def flush(self, timeout: float = 10.0) -> bool:
        """Block until everything queued so far has been posted (or the
        router shut down). Returns True if fully drained."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self._shutdown.is_set():
                return False
            if self._q.empty() and self._idle.is_set():
                return True
            time.sleep(0.02)
        return False

    def close(self):
        self.flush()
        self._shutdown.set()
