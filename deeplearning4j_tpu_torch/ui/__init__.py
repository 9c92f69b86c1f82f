"""Observability UI stack — training stats capture, storage, dashboard
(the JAX package's `ui/`; DL4J's StatsListener, StatsStorage and
PlayUIServer).

`storage`, `i18n`, `components` and `server` are copies of the
reference's framework-neutral modules; `stats.StatsListener` reads the
port's tensors and summarizes them where they lie. Exports resolve
lazily (`util/lazy.py`): importing this package loads no submodule, and
torch only comes with `StatsListener`.
"""
from deeplearning4j_tpu_torch.util.lazy import lazy_exports

_EXPORTS = {
    **dict.fromkeys(("FileStatsStorage", "InMemoryStatsStorage",
                     "RemoteUIStatsStorageRouter", "StatsRecord",
                     "StatsStorage", "StatsStorageRouter"), "storage"),
    "StatsListener": "stats",
    "UIServer": "server",
}
__all__ = [
    "FileStatsStorage", "InMemoryStatsStorage",
    "RemoteUIStatsStorageRouter", "StatsRecord",
    "StatsStorage", "StatsStorageRouter", "StatsListener", "UIServer",
]
__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
