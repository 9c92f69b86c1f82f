"""Nearest-neighbors REST server + client.

Parity: DL4J `deeplearning4j-nearestneighbor-server/.../NearestNeighborsServer.java:42`
(Play routes `POST /knn` — k neighbors of an already-indexed point — and
`POST /knnnew` — k neighbors of a new vector) and the matching
`deeplearning4j-nearestneighbor-client`. A stdlib ThreadingHTTPServer over
the in-tree VPTree (the ui/server.py pattern: no dependency beyond numpy),
JSON instead of DL4J's binary ndarray wire format; routes, JSON and errors
are the JAX package's.

Routes:
    GET  /health          -> {"status": "ok", "points": N, "dim": D}
    POST /knn             {"index": i, "k": k}   -> {"results": [...]}
    POST /knnnew          {"arr": [...], "k": k} -> {"results": [...]}
    POST /insert          {"arr": [...]}          -> {"index": new_index}
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib import request as urlrequest

import numpy as np

from deeplearning4j_tpu_torch.clustering.vptree import VPTree


class NearestNeighborsServer:
    """Serve k-NN queries over a point set (NearestNeighborsServer.java:42).

    Inserts are accepted into a side buffer that is linearly scanned and
    merged with the VP-tree results, so /insert is O(1) and the tree is
    rebuilt lazily only when the buffer outgrows `rebuild_threshold`.
    """

    def __init__(self, points, port: int = 0, metric: str = "euclidean",
                 rebuild_threshold: int = 256):
        self.points = np.asarray(points, np.float32)
        self.metric = metric
        self.rebuild_threshold = rebuild_threshold
        self._tree = VPTree(self.points, metric=metric)
        self._extra: List[np.ndarray] = []
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port = port

    # --------------------------------------------------------------- knn
    def _all_points_locked(self) -> np.ndarray:
        """Caller must hold self._lock (insert() rebuilds in two steps)."""
        if not self._extra:
            return self.points
        return np.concatenate([self.points, np.stack(self._extra)])

    def _all_points(self) -> np.ndarray:
        with self._lock:
            return self._all_points_locked()

    def knn_index(self, index: int, k: int):
        with self._lock:
            pts = self._all_points_locked()
            if not 0 <= index < len(pts):
                raise IndexError(f"index {index} out of range ({len(pts)})")
            vec = pts[index]
        return self.knn_vector(vec, k)

    def knn_vector(self, vec, k: int):
        from deeplearning4j_tpu_torch.clustering.vptree import _dist
        vec = np.asarray(vec, np.float32)
        with self._lock:
            idxs, dists = self._tree.knn(vec, k)
            results = list(zip(idxs, dists))
            base = len(self.points)
            # side buffer scanned with the SAME metric as the tree
            for j, p in enumerate(self._extra):
                results.append((base + j, float(_dist(vec, p, self.metric))))
        results.sort(key=lambda r: r[1])
        return results[:k]

    def insert(self, vec) -> int:
        vec = np.asarray(vec, np.float32)
        if vec.shape != (self.points.shape[1],):
            raise ValueError(f"expected dim {self.points.shape[1]}, "
                             f"got {vec.shape}")
        with self._lock:
            self._extra.append(vec)
            idx = len(self.points) + len(self._extra) - 1
            if len(self._extra) >= self.rebuild_threshold:
                self.points = self._all_points_locked()
                self._tree = VPTree(self.points, metric=self.metric)
                self._extra = []
        return idx

    # ------------------------------------------------------------- serve
    def start(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):       # silence request logging
                pass

            def _json(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    pts = server._all_points()
                    self._json(200, {"status": "ok", "points": len(pts),
                                     "dim": int(pts.shape[1])})
                else:
                    self._json(404, {"error": "unknown route"})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    if self.path == "/knn":
                        res = server.knn_index(int(payload["index"]),
                                               int(payload.get("k", 1)))
                    elif self.path == "/knnnew":
                        res = server.knn_vector(payload["arr"],
                                                int(payload.get("k", 1)))
                    elif self.path == "/insert":
                        self._json(200,
                                   {"index": server.insert(payload["arr"])})
                        return
                    else:
                        self._json(404, {"error": "unknown route"})
                        return
                    self._json(200, {"results": [
                        {"index": int(i), "distance": float(d)}
                        for i, d in res]})
                except (KeyError, ValueError, IndexError) as e:
                    self._json(400, {"error": str(e)})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="nn-server")
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class NearestNeighborsClient:
    """HTTP client for NearestNeighborsServer (the reference's
    nearestneighbor-client analog)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9000):
        self.base = f"http://{host}:{port}"

    def _post(self, route: str, payload: dict) -> dict:
        req = urlrequest.Request(
            self.base + route, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urlrequest.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())

    def health(self) -> dict:
        with urlrequest.urlopen(self.base + "/health", timeout=30) as resp:
            return json.loads(resp.read())

    def knn(self, index: int, k: int = 1) -> List[dict]:
        return self._post("/knn", {"index": index, "k": k})["results"]

    def knn_new(self, vector, k: int = 1) -> List[dict]:
        return self._post("/knnnew",
                          {"arr": np.asarray(vector).tolist(),
                           "k": k})["results"]

    def insert(self, vector) -> int:
        return self._post("/insert",
                          {"arr": np.asarray(vector).tolist()})["index"]
