"""Storage monitoring: health checks, query logging, alerting. A copy of
``youtu_rag_tpu/retrieval/monitoring.py`` over the port's store (``check_health``
calls ``TorchVectorStore.health()``).

Parity with ``utu/rag/monitoring/`` (``StorageMonitor``/``HealthChecker``,
``unified_monitor.py:15-292``): per-store health + metrics, query-latency
logging with alert thresholds from MonitorConfig
(``utu/rag/config.py:68-82``), and a unified monitor aggregating all
registered stores into summary/detailed reports."""

from __future__ import annotations

import time
from collections import deque
from typing import Any

from ..core.config import MonitorConfig
from ..core.types import BaseStorageMonitor, HealthStatus, QueryLogEntry
from ..utils.log import get_logger

logger = get_logger("retrieval.monitoring")


class StorageMonitor(BaseStorageMonitor):
    def __init__(self, store, config: MonitorConfig | None = None, name: str = "store"):
        self.store = store
        self.config = config or MonitorConfig()
        self.name = name
        self._queries: deque[QueryLogEntry] = deque(maxlen=10000)
        self._errors = 0
        # bounded like _queries: a sustained-slow backend must not grow
        # process memory for the server's lifetime
        self._alerts: deque[dict[str, Any]] = deque(maxlen=1000)

    async def check_health(self) -> HealthStatus:
        try:
            if hasattr(self.store, "health"):
                return await self.store.health()
            n = await self.store.count()
            return HealthStatus(
                is_healthy=True,
                backend=type(self.store).__name__,
                collection_name=self.name,
                total_chunks=n,
                last_check_time=time.strftime("%Y-%m-%dT%H:%M:%S"),
            )
        except Exception as e:  # noqa: BLE001
            return HealthStatus(
                is_healthy=False,
                backend=type(self.store).__name__,
                collection_name=self.name,
                last_check_time=time.strftime("%Y-%m-%dT%H:%M:%S"),
                errors=[str(e)],
            )

    async def log_query(self, query: str, latency_ms: float, result_count: int) -> None:
        # alerting is independent of query logging (separate config
        # switches) — a disabled log must not silence slow-query alerts
        threshold = self.config.alert_thresholds.get("query_latency_ms", 1000.0)
        if self.config.enable_alerts and latency_ms > threshold:
            alert = {
                "type": "slow_query",
                "latency_ms": latency_ms,
                "threshold_ms": threshold,
                "time": time.time(),
            }
            self._alerts.append(alert)
            logger.warning("slow query alert: %.1fms > %.1fms", latency_ms, threshold)
        if not self.config.enable_query_logging:
            return
        self._queries.append(QueryLogEntry(query[:200], latency_ms, result_count))

    def log_error(self) -> None:
        self._errors += 1

    async def get_query_stats(self, time_range_hours: int = 24) -> dict[str, Any]:
        cutoff = time.time() - time_range_hours * 3600
        recent = [q for q in self._queries if q.timestamp >= cutoff]
        lat = sorted(q.latency_ms for q in recent)
        n = len(lat)
        return {
            "window_hours": time_range_hours,
            "query_count": n,
            "avg_latency_ms": sum(lat) / n if n else 0.0,
            "p50_latency_ms": lat[n // 2] if n else 0.0,
            "p95_latency_ms": lat[min(int(n * 0.95), n - 1)] if n else 0.0,
            "max_latency_ms": lat[-1] if n else 0.0,
            "error_count": self._errors,
            "error_rate": self._errors / max(n + self._errors, 1),
            "alerts": len(self._alerts),
        }

    async def collect_metrics(self) -> dict[str, Any]:
        health = await self.check_health()
        stats = await self.get_query_stats()
        out = {
            "name": self.name,
            "healthy": health.is_healthy,
            "total_chunks": health.total_chunks,
            "index_size_bytes": health.index_size_bytes,
            **stats,
        }
        # search-coalescer effectiveness (dispatch amortization), when on
        coalescer = getattr(self.store, "_search_coalescer", None)
        if coalescer is not None:
            s = coalescer.stats
            out["search_coalescing"] = {
                **s,
                "avg_merged": round(s["queries"] / s["dispatches"], 2)
                if s["dispatches"]
                else 0.0,
            }
        # corpus BM25 inverted index (hybrid retrieval's lexical side)
        lexical = getattr(self.store, "_lexical", None)
        if lexical is not None:
            out["lexical_index"] = lexical.stats()
        return out


class UnifiedStorageMonitor:
    """Aggregates monitors across stores (ref: unified_monitor.py:15-292)."""

    def __init__(self, config: MonitorConfig | None = None):
        self.config = config or MonitorConfig()
        self.monitors: dict[str, StorageMonitor] = {}

    def register(self, name: str, store) -> StorageMonitor:
        mon = StorageMonitor(store, self.config, name=name)
        self.monitors[name] = mon
        return mon

    def unregister(self, name: str) -> bool:
        """Drop a backend's monitor (KB deletion — a stale entry keeps the
        cleared store alive and forever reports a deleted backend)."""
        return self.monitors.pop(name, None) is not None

    async def check_all_health(self) -> dict[str, HealthStatus]:
        return {name: await m.check_health() for name, m in self.monitors.items()}

    async def get_all_metrics(self) -> dict[str, dict[str, Any]]:
        return {name: await m.collect_metrics() for name, m in self.monitors.items()}

    async def summary(self) -> dict[str, Any]:
        health = await self.check_all_health()
        healthy = sum(1 for h in health.values() if h.is_healthy)
        return {
            "total_backends": len(health),
            "healthy_backends": healthy,
            "overall_healthy": healthy == len(health),
            "backends": {n: h.is_healthy for n, h in health.items()},
            "checked_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }

    async def detailed_report(self) -> dict[str, Any]:
        return {
            "summary": await self.summary(),
            "metrics": await self.get_all_metrics(),
        }
