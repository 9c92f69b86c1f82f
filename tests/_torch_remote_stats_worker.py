"""Worker process for the port's remote stats router test: posts stats
records to the dashboard process's UIServer over HTTP through the port's
storage (a stdlib client: neither torch nor jax is imported)."""
import sys
import time

sys.path.insert(0, sys.argv[2])

from deeplearning4j_tpu_torch.ui.storage import (          # noqa: E402
    RemoteUIStatsStorageRouter, StatsRecord,
)


def main():
    url = sys.argv[1]
    router = RemoteUIStatsStorageRouter(url)
    sid = "remote-sess-1"
    router.put_static_info(StatsRecord(
        session_id=sid, type_id="StatsListener", worker_id="worker-7",
        timestamp=time.time(), data={"model": "mlp", "n_params": 42}))
    for i in range(5):
        router.put_update(StatsRecord(
            session_id=sid, type_id="StatsListener", worker_id="worker-7",
            timestamp=time.time() + i, data={"score": 1.0 / (i + 1),
                                             "iteration": i}))
    ok = router.flush(timeout=20)
    router.close()
    print("FLUSHED" if ok else "FLUSH-TIMEOUT")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
