"""RAG configuration tree.

Semantic parity with the reference config (``utu/rag/config.py:10-99``):
chunking / embedding / builder / retriever / vector-store / monitor
sections composed into one ``RAGConfig``. Device-index knobs live in
``IndexConfig`` (block sizes, dtype, IVF) — a *new* section with no
reference counterpart, since the reference delegates indexing to
Chroma/FAISS. A copy of ``youtu_rag_tpu/core/config.py``; only the vector
store's backend literal differs ("torch" or "numpy"; a config naming the
JAX package's "tpu" engine reads as "torch"). The device is not a config
field: it is a constructor argument of the index, the store and the
knowledge base.
"""

from __future__ import annotations

from typing import Any, Literal

from pydantic import BaseModel, ConfigDict, Field, field_validator


class ConfigBase(BaseModel):
    """Base for all config models: secret-masking repr + exclude-none dumps.

    Mirrors the contract of ``utu/config/base_config.py:8-38``.
    """

    model_config = ConfigDict(extra="allow")

    _MASKED = ("api_key", "base_url", "token", "password", "secret")

    def __repr__(self) -> str:
        parts = []
        for k, v in self.__dict__.items():
            if v is None:
                continue
            if any(m in k for m in self._MASKED) and isinstance(v, str) and v:
                v = v[:4] + "***"
            parts.append(f"{k}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"

    def model_dump(self, **kwargs) -> dict:
        kwargs.setdefault("exclude_none", True)
        return super().model_dump(**kwargs)


class ChunkingConfig(ConfigBase):
    """Ref: utu/rag/config.py:10-17."""

    strategy: Literal["recursive", "hierarchical"] = "recursive"
    chunk_size: int = Field(default=1000, ge=100, le=10000)
    chunk_overlap: int = Field(default=200, ge=0, le=1000)
    separators: list[str] | None = None
    keep_separator: bool = True


class EmbeddingConfig(ConfigBase):
    """Ref: utu/rag/config.py:20-28. Provider ``tpu`` runs the in-repo
    jit-compiled encoder; ``hash`` is the deterministic test embedder;
    ``openai``/``service`` call remote HTTP endpoints like the reference."""

    model: str = "tpu-encoder-base"
    provider: Literal["auto", "tpu", "hash", "openai", "service"] = "hash"
    api_key: str | None = None
    base_url: str | None = None
    batch_size: int = Field(default=128, ge=1, le=4096)
    dimensions: int | None = None
    batch_delay: float = Field(default=0.0, ge=0.0, le=60.0)
    # provider "tpu": serve a pretrained BERT-family checkpoint directory
    # (config.json + model.safetensors + vocab.txt — models/pretrained.py)
    # instead of the repo's own encoder weights
    pretrained_dir: str | None = None
    # provider "tpu": serve a train_embedder output directory
    # (encoder_params.npz + encoder_config.json [+ vocab.txt]) — e.g. the
    # committed benchmarks/models/yrt_tiny_lex lexical-residual encoder
    weights_dir: str | None = None
    # >0 enables request coalescing: concurrent embed calls inside the
    # window batch into one device dispatch (serving-throughput knob)
    coalesce_window_ms: float = Field(default=0.0, ge=0.0, le=100.0)


class RerankerConfig(ConfigBase):
    """Reranker backend selection (ref factory: utu/rag/rerankers/factory.py:15-216)."""

    provider: Literal["none", "tpu", "lexical", "openai", "service", "jina", "tione"] = "none"
    model: str | None = None
    api_key: str | None = None
    base_url: str | None = None
    batch_size: int = Field(default=64, ge=1, le=1024)


class KnowledgeBuilderConfig(ConfigBase):
    """Ref: utu/rag/config.py:31-40."""

    chunking: ChunkingConfig = Field(default_factory=ChunkingConfig)
    embedding: EmbeddingConfig = Field(default_factory=EmbeddingConfig)
    max_workers: int = Field(default=4, ge=1, le=64)
    enable_metadata: bool = True
    metadata_fields: list[str] = Field(default_factory=lambda: ["source", "page", "title"])
    batch_delay: float = Field(default=0.0, ge=0.0, le=60.0)
    # scale guards for spreadsheet ingestion (the reference row-samples big
    # sheets; a whole-sheet to_markdown on a 100k-row sheet OOMs):
    max_fulltext_rows: int = Field(default=2000, ge=1)
    max_row_docs: int = Field(default=1024, ge=1)


class RetrieverConfig(ConfigBase):
    """Ref: utu/rag/config.py:43-50. threshold<=0 disables filtering
    (utu/rag/knowledge_retrieval/base_retriever.py:60-66)."""

    top_k: int = Field(default=5, ge=1)
    similarity_threshold: float = Field(default=0.0, ge=0.0, le=1.0)
    enable_reranking: bool = False
    reranker_model: str | None = None
    reranker_top_k: int = Field(default=3, ge=1, le=50)
    recall_multiplier: int = Field(default=3, ge=1, le=10)
    # hybrid fusion: weight of the dense ranking in weighted RRF
    # (1-alpha goes to the corpus BM25 ranking). 0.5 = classic RRF;
    # lower it for exact-term workloads (needle/NIAH-style corpora)
    # where lexical evidence should dominate
    hybrid_alpha: float = Field(default=0.5, ge=0.0, le=1.0)


class IndexConfig(ConfigBase):
    """Device-index knobs (new; no reference counterpart — replaces
    Chroma HNSW / FAISS flat params from utu/rag/config.py:63-66)."""

    kind: Literal["flat", "ivf"] = "flat"
    metric: Literal["cosine", "l2", "ip"] = "cosine"
    # int8: symmetric per-row quantization + f32 scales (half the HBM
    # bytes of bf16). int4: two columns packed per byte (half of int8
    # again — the next QPS tier; full feature matrix: brute, IVF (DMA
    # kernel over packed rows), db-axis sharding, multi-process. Recall
    # floor + two-stage recovery in benchmarks/recall_report.json)
    storage_dtype: Literal["bfloat16", "float32", "int8", "int4"] = "bfloat16"
    # int4 two-stage search (ScaNN-style): the device kernel generates
    # int4_rerank_multiplier × k candidates from packed nibbles, then the
    # host re-scores that tiny set from an int8 shadow copy kept in host
    # RAM (d bytes/row — a 1M×768 KB costs ~0.8 GB host RAM, 0 HBM).
    # Recovers int8-level recall while HBM stays at int4 bytes.
    # 0/1 disables the re-rank (raw int4 recall floor).
    int4_rerank_multiplier: float = Field(default=4.0, ge=0.0)
    block_rows: int = Field(default=1024, description="DB rows per kernel block")
    # big appends commit in slices of this many rows so concurrent
    # queries interleave between sub-appends instead of waiting behind
    # one monolithic host→device transfer (the during-build p95 lever;
    # 0 = single-shot commit). Must be a power of two (static-shape
    # invariant — validated below).
    append_slice_rows: int = Field(default=4096, ge=0)

    @field_validator("append_slice_rows")
    @classmethod
    def _slice_rows_pow2(cls, v: int) -> int:
        if v and v & (v - 1):
            raise ValueError(f"append_slice_rows must be a power of two, got {v}")
        return v
    min_capacity: int = Field(default=4096)
    max_metadata_columns: int = Field(default=16)
    # IVF
    n_lists: int = Field(default=1024, ge=1)
    n_probe: int = Field(default=64, ge=1)
    kmeans_iters: int = Field(default=10, ge=1)
    # adaptive nprobe: drop probed clusters whose centroid score trails the
    # per-query best by more than this margin (0 disables). Easy queries
    # probe fewer blocks; hard queries keep the full n_probe set.
    ivf_adaptive_margin: float = Field(default=0.0, ge=0.0)
    ivf_min_probe: int = Field(default=4, ge=1)
    # closed-loop nprobe auto-tuning: every ivf_tune_interval IVF query
    # batches, one batch is shadow-checked against brute force; n_probe
    # grows by ivf_probe_step while recall@k < target and shrinks when
    # comfortably above. 0 disables (default).
    ivf_recall_target: float = Field(default=0.0, ge=0.0, le=1.0)
    ivf_tune_interval: int = Field(default=64, ge=1)
    ivf_probe_step: float = Field(default=1.5, gt=1.0)
    # residual re-ranking: probe for k x this many candidates, then
    # re-score them exactly (f32 gather + dot) and keep the true top-k.
    # Recovers order lost to quantized/pruned approximate scoring —
    # recall@k insurance for adversarial (overlapping-cluster) data.
    # <= 1 disables (default).
    ivf_rerank_multiplier: float = Field(default=0.0, ge=0.0)
    # maintenance
    auto_compact_ratio: float = Field(
        default=0.5,
        ge=0.0,
        le=1.0,
        description="compact when tombstones exceed this fraction of rows "
        "(0 disables). Reclaims HBM and restores scan efficiency.",
    )
    # sharding
    shard_axis: str = "db"
    num_shards: int | None = None  # None → all local devices


class VectorStoreConfig(ConfigBase):
    """Ref: utu/rag/config.py:53-66. ``backend``: "torch" is the port's
    device index on the store's device, "numpy" the exact host index
    (``index/numpy_ref.py``), as in JAX."""

    backend: Literal["torch", "numpy"] = "torch"
    collection_name: str = "knowledge_base"
    persist_directory: str = "./data/vector_store"
    distance_metric: Literal["cosine", "euclidean", "dot"] = "cosine"
    index: IndexConfig = Field(default_factory=IndexConfig)
    # >0: concurrent searches inside the window merge into one fused
    # kernel launch (per top_k+filter signature) — the serving hot path
    # pays one dispatch for N concurrent requests, like the embedder's
    # coalesce_window_ms
    coalesce_window_ms: float = Field(default=0.0, ge=0.0, le=100.0)
    # corpus-level BM25 inverted index maintained alongside the device
    # index; gives HybridRetriever lexical recall that is independent of
    # dense-encoder quality (needle-style queries survive a weak encoder).
    # Host-RAM cost is ~3.3 KB per chunk (array-backed postings; measured
    # 50k x 120-token chunks -> 165 MB) — right for KBs up to ~2M chunks;
    # disable for 10M-chunk single-host deployments or shard hosts.
    lexical_index: bool = True

    @field_validator("backend", mode="before")
    @classmethod
    def _device_engine(cls, v: Any) -> Any:
        # the shared configs/rag/*.yaml name the JAX package's device engine
        # ("tpu"); in the port the device engine is the torch index
        return "torch" if v == "tpu" else v


class MonitorConfig(ConfigBase):
    """Ref: utu/rag/config.py:69-82."""

    enable_monitoring: bool = True
    health_check_interval: int = Field(default=60, ge=10, le=3600)
    metrics_retention_days: int = Field(default=30, ge=1, le=365)
    enable_query_logging: bool = True
    enable_alerts: bool = True
    alert_thresholds: dict[str, float] = Field(
        default_factory=lambda: {
            "query_latency_ms": 1000.0,
            "error_rate": 0.05,
            "index_size_gb": 100.0,
        }
    )


class RAGConfig(ConfigBase):
    """Ref: utu/rag/config.py:85-99."""

    name: str = "default_rag"
    description: str | None = None

    knowledge_builder: KnowledgeBuilderConfig = Field(default_factory=KnowledgeBuilderConfig)
    retriever: RetrieverConfig = Field(default_factory=RetrieverConfig)
    reranker: RerankerConfig = Field(default_factory=RerankerConfig)
    vector_store: VectorStoreConfig = Field(default_factory=VectorStoreConfig)
    monitor: MonitorConfig = Field(default_factory=MonitorConfig)

    enable_cache: bool = True
    cache_ttl: int = Field(default=3600, ge=60, le=86400)
    log_level: Literal["DEBUG", "INFO", "WARNING", "ERROR"] = "INFO"


def rag_config_from_dict(data: dict[str, Any]) -> RAGConfig:
    return RAGConfig.model_validate(data)
