#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (youtu_rag_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero before the result lines:
  1. environment: the card's name and power limit, torch and CUDA versions;
     fails without a CUDA device;
  2. build: compiles the path's five kernel sources from csrc/ at once (one
     nvcc per source: the ring's three, ivf_topk_bf16.cu, ivf_topk_int8.cu
     and ivf_topk_int4.cu, attention.cu and topk_blocks.cu) and prints each
     build's time and ptxas' register and spill report and warnings (the
     per-block candidates' scan kernels in three k classes; the attention
     source's Hopper kernels, attention_wgmma.cuh's attention_kernel for hd
     64 and 128 and its three entries, blockwise, flash and the hop's stats,
     and its mma.sync kernels for f32), then one line per attention kernel
     and ring kernel (ivf_scan_tma.cuh: the bf16, int8 and int4 DMA
     entries, whose kernels the brute scans take, and the bf16 / int8
     per-block ones) with its registers and spills;
  2b. the index's tier warm-up (``ensure_tier_ready`` and the next-tier
     warm), before any ring library is loaded in the process: the run's
     provenance (``utils/provenance.py``: seed, commit, time, the card's
     name and power limit); then per tier, bf16 and int8, a never-warmed
     index and a warmed one (bf16 cold first, int8 warm first) each fill
     524,288 × 768 seeded unit rows at that capacity, search q = 1 and 8
     at k 10 and grow to 1,048,576 rows of capacity by a 65,536-row append;
     prints the wall time of the index's first searches, of the growth
     and of the first searches after it, warmed and cold, beside the
     median of five more and the card's name and power limit; fails
     unless the warmed index's library was loaded by the end of its fill,
     ensure_tier_ready launched both signatures at 1,048,576 and marked
     them warmed, the cold one warmed nothing, query 0's top hit is its
     stored row, and the hits after the growth are equal, warmed and cold
     (ids and scores, bit for bit);
  2c. the ring's plans: the TMA IVF entries' shared-memory plan and CTAs
     per SM for d 128-8192 (int4 256-8192) x k 1-8192 (fails where a cell
     has none);
  3. kernel vs plain, top-k: each top-k kernel against its plain PyTorch
     version on the card, over the shapes and edge cases of KERNEL_CASES
     (k up to 1024): bf16 within TOL, int8 and int4 bit-equal on the same
     quantized tensors; then the int4 kernel alone over INT4_CASES (d 256
     and 4096, row counts that are not a multiple of 64);
  3x. kernel vs plain, any query count and k above 1024: q = 0 (no launch,
     an empty result), 65, 100 and 130 (one launch per 64 queries) through
     all ten top-k wrappers (the per-block IVF ones merged by their kernel
     and as candidates); k = 2048 and 4096 (bf16, int4) and 8192 (int8)
     through the pruned kernels, k = 2048 through one IVF case and the
     per-block candidates, and the merged per-block IVF calls at k = 1024,
     2048 and 4096 (= block_rows); each held to its plain version as in
     phases 3, 3c and 3d;
  3b. kernel vs plain, attention: blockwise (T 256, 384, 512, 640, 4096)
     and flash (T 4224, 8192) against their plain versions, hd 64 and 128,
     bf16 (the Hopper kernels) and f32, with padded keys and a batch row
     whose every key is masked, and both entries on the encoder's strided
     q, k, v views, within compare_attention's tolerance; any NaN fails;
  3e. kernel vs plain, the ring hop: ``flash_attention_stats`` (bf16 on
     the Hopper kernel's stats entry, f32 on the mma.sync kernel) at T =
     T_kv = 128 (one key tile), 256, 1024 and 8192, T = 1024 against T_kv =
     128, 512 and 4096, hd 64 and 128, bf16 and f32, padded keys, a fully
     masked row and a span whose every key is padding, the encoder's
     strided q, k, v views, and [16, 12, 512, 64] (768 work items, several
     per CTA): m, l and acc / l (compare_stats); two half-span hops
     combined against ``flash_attention`` on the whole span;
  3c. kernel vs plain, IVF: each IVF kernel against its plain version over
     IVF_CASES (k 1 to 1024, q 1 to 64, block_rows 64, 1024 and 4096) and
     the plan's edges (n_valid 0, 1 and max_blocks, garbage ids past
     n_valid, NEG_INF and -inf rows, fewer live rows than k): bf16 within
     TOL, int8 and int4 bit-equal, ties in probe order, every empty slot
     NEG_INF with the plain version's fill row (JAX's: the best live row
     before the last probed block with one); then the int4 kernel alone at block_rows
     4, 8 and 12 (stages and 16-row groups that straddle blocks) and k up
     to 2048, and the three kernels over IVF_TMA_CASES (q 1, 7, 9, 65;
     k 1, 129, 1025; block_rows 4, 12, 4096; f32 queries and ascending ids,
     bf16 queries and shuffled ids; a zero query row), one launch per 64
     queries;
  3f. kernel vs plain, IVF inputs JAX takes: the three DMA entries at
     block_rows 1, 2, 6, 66 and 1026 with bias and scales 4 bytes past a
     16-byte boundary, k up to block_rows; the three DMA entries and the
     bf16 and int8 merged per-block entries at d 4096 and 8192 with k up to
     4096 (lists in device memory; bf16 at d = 8192 the wide plan); as in
     phases 3c, 3d;
  3d. kernel vs plain, per-block: the four per-block kernels (``topk``,
     ``topk_int8``, ``ivf_topk``, ``ivf_topk_int8``) against their plain
     versions over BLOCKS_CASES (k 1 to 1024 and k = block_rows, q 1 to
     64, block_rows 4 to 4096; NEG_INF and -inf rows, a block scoring -inf
     throughout, fewer live rows than k, no live row with position 0 all
     -inf (the tail's last slot from position 1, the pad or a one-block
     plan's -inf); plans with n_valid 0, 1, half and max_blocks, ids
     ascending and shuffled; brute takes each case's shape once, the plan
     dropped): every candidate slot of ``csrc/topk_blocks.cu``, the fill
     and the pad included, and the merged call (``csrc/ivf_scan_tma.cuh``'s
     per-block entries, brute over the identity plan; one launch per 64
     queries) against the merged plain candidates (``topk``: through
     ``fused_topk(backend="pallas_interpret")``), ties in row or probe
     order; rows equal (bf16: a swap of two rows scoring within TOL of each
     other allowed), bf16 scores within TOL, int8 bit-equal, the tail slot
     for slot;
  4. main path, small corpus: about 20 markdown files through the port's
     KnowledgeBase (hash embedder → device index → kernel → retrievers)
     as three KBs, one per storage tier (bf16, int8, int4), each checked
     for the intended top documents and against the same KB on the CPU;
     the int4 hybrid query asks its kernel for k = 256; the int4 KB is
     then saved and loaded into a fresh CUDA KB, which answers the same;
  4c. main path, small corpus, IVF: the phase-4 corpus through a CUDA KB per
     tier with block_rows 64 and ``build_ivf()``: the intended top
     documents, the same top documents as the CPU twin, IVF launches and no
     brute launch; each IVF call of the path held against its plain
     version; then save and load into a fresh CUDA KB that builds IVF
     again and answers the same;
  4b. main path, small corpus, encoder (provider "tpu"): (a) the default
     encoder's width (768, seeded, attention_impl "pallas", the KB's
     default checked) at ENC4B_LAYERS of its 12 layers through a CUDA KB of
     the phase-4 corpus and three exact-identifier documents, held to the
     same KB on the CPU (the kernels' plain versions) by ENC_TOL; blockwise
     launches a multiple of the layers; (b) the
     committed yrt_tiny_lex as its config says (no attention launches),
     ranking the exact-identifier documents, then served with "pallas",
     which must give the same top documents;
  4d. main path, small corpus, long documents: six documents of ~1,200
     tokens whose own passage starts past token 512, one chunk each at
     ``chunk_size`` 10,000, through a CUDA KB served by the default
     full-width encoder with sp_mesh=4: every query answered from its
     document, hop launches a positive multiple of 12 x 4 (the same KB cut
     at max_len is printed for contrast); then a small encoder (128 wide,
     2 layers, 2 heads of 64) with sp_mesh=4, whose top documents on the
     card equal its CPU twin's;
  4e. main path, a pretrained BERT-family checkpoint: a BERT-base embedder
     (bge-base-en-v1.5's config, CLS pooling; safetensors F32) and a
     one-label cross-encoder (bert-base-uncased's widths; BF16) written
     from a seed with a 30,522-entry vocab.txt, served through a CUDA KB
     with ``EmbeddingConfig(provider="tpu", pretrained_dir=...)`` and
     ``TorchReranker.from_pretrained`` over phase 4's topics as one chunk
     of ~450 tokens each (T = 512): the stored embeddings and every
     document's dense rank against a CPU f32 twin, the same forward with
     plain attention, the kernel's attention output against plain
     attention within one bf16 ulp, the cross-encoder's scores and order
     against a CPU f32 twin (ENC_TOL), blockwise launches 12 per forward
     at T >= 256 and none below; then BERT-base embeddings/s at B = 128,
     T = 512 (device and embed_batch, WordPiece apart), the forward's split
     (attention kernel, GEMMs, the rest), the forward with SDPA in the
     kernel's place, and cross-encoder pairs/s at B = 64, T = 512;
  4f. main path, ingest through the staged builder: 1,024 markdown files
     of ~6,000 characters written from the seed (one fact sentence each)
     through ``KnowledgeBase(...).build_sources`` on the card with the
     default ChunkingConfig: (a) the default hash provider (the native C
     tokenizer and hash embedder, the bf16 index): the report (1,024
     processed, none failed), a CPU twin with the same chunk ids and
     bit-equal stored embeddings, 64 fact questions each answered from
     their document in the hybrid top 5 on both (the dense top 50 the same
     up to ties within TOL), topk_pruned launched; the build's wall time,
     chunks/s and split (load and chunk, embed, lexical update, index
     add), and HashEmbedder (1,024 chunks) and HashTokenizer.batch (128
     chunks) on their Python and C paths; (b) the same tasks again (all
     skipped, no index add), 16 files rewritten (16 processed, each
     source's count_by_document right) and 8 sources cleaned (no chunk
     left, their facts no longer answered); (c) the encoder provider (the
     default 768 x 12 encoder from the seed, "pallas") over the first 256
     files: every source's chunks at T = 256, blockwise launches a positive
     multiple of 12, INGEST_ENC_CHECKED stored embeddings against a CPU
     TorchEmbedder (plain attention) within ENC_TOL, chunks/s and embed's split into
     tokenization and forward; whether pandas imports is printed;
  4g. memory and toolkits: (a) a multi-tenant memory store at a shared
     deployment's size: 262,144 memories of 1,024 users (per user 64
     working over 4 sessions, 96 episodic, 64 semantic, some with a
     text2sql category, 32 skills with use and success counts; importance
     and created_at from the seed) in one bf16 MemoryVectorStore index of
     262,144 x 256 on the card, seeded through its store's batched
     ``add_chunks`` with the metadata ``add`` writes, both memory modules on
     one frozen clock; for 64 users against a CPU twin that holds their
     nodes: search_memory (top 5), search_memories with min_importance 0.7
     ($gte on a float column) and with a category, retrieve_all_context (8)
     return the same node ids with scores within TOL (near-ties may swap),
     every hit the asking user's and of the asked types (tenant isolation,
     a hard gate), importance edits move a memory across the $gte line in
     place, a content edit keeps the count and finds the new text,
     cleanup_procedural leaves no failing skill, the same answers as the
     twin; one user's memories saved and loaded into a fresh store on the
     card answer as the shared store; topk_pruned's launches; reported:
     the host-clock medians of search_memory, retrieve_all_context and
     get_working_memory, the filtered kernel's device time beside its bytes
     bound and the unfiltered kernel on the same index, the filter mask's
     time, and 1,024 ``add`` calls' ms per memory; (b) agents from configs
     (``ConfigLoader`` where the host has yaml, else the same configs from
     CONFIG_DICTS; whether yaml imports is printed): memory_chat through
     ``get_agent`` (run 1 stores a fact, run 2's instructions carry it
     under "## Relevant memory" with a stored skill, whose stats move), the
     meta_retrieval agent over 64 dated documents (its 2021 search returns
     only 2021 documents), the text2sql toolkit over a KB that
     ``build_sources`` makes of 4 CSV sources and over a ``sqlite:///``
     ``database_url`` with a scripted model, each against a CPU twin, and
     the rag toolkit's add, search and clear on a CUDA KB; no run may
     report an error;
  4h. agents from configs: orchestrators, environments, the trajectory
     store: a team's KB (1,024 of 4f's files, the hash provider, hybrid) on the
     card and its CPU twin under two names, and text2sql KBs of 4g's CSV
     sources with its sqlite ``database_url``; (a) the shipped configs
     orchestra_example, orchestrator/chain and orchestrator/parallel
     (max_parallel 4) on 8 of 4f's facts each, workforce_example on 4 and
     examples/text2sql through ``ConfigLoader`` (it needs yaml) and
     ``get_agent`` (no ``device``: the card), each against its CPU twin
     (``device="cpu"``):
     scripted planners, workers built from the config's worker entries with
     scripted models that run one kb_hybrid_search of their question;
     gates: no run or worker run reports an error, each fact's document is
     in its worker's observation, the final output, the orchestrator's
     trajectory and events per stream, every worker run (events,
     trajectory, tool calls, output) the twin's (observations up to
     near-ties within TOL), text2sql's SQL and answer the twin's, and
     topk_pruned launched at least once per worker search; (b) each run
     writes one TrajectoryRecord through a trajectory sink into a
     ``DBService`` on sqlite and its spans through
     ``setup_tracing(db_service=...)``: one record per run, the record and
     the tool and generation trace rows the twin's (ids, clocks and
     durations left out); (c) a SimpleAgent with ``env: shell_local`` runs
     run_bash and execute_python_code in its workspace, gone after
     ``cleanup``, and whether ``BrowserEnv`` builds is printed; (d)
     orchestra_example with its workers' model ``provider: local``
     (yrt_tiny_chat): the orchestrator builds them from config as
     LocalChatClient on cuda, no error, the transcript beside the CPU
     port's (printed); (e) host-clock median and spread of 8 runs per
     config, topk_pruned launches and device ms per run, the parallel
     orchestrator with coalesce_window_ms 0 and 2 (the same results), the
     StorageMonitor's health of the card's store (healthy, every chunk) and
     collect_metrics' time; (g) the operator commands over the card's
     trajectory DB, each held against the DB itself: ``python -m
     youtu_rag_tpu_torch.db_dump`` (every table's count and min(50, count)
     rows), ``trace_search --name kb_hybrid_search`` (every tool line of
     that name, min(30, count) of them, then min(30, count) generation
     lines), ``analysis.tool_usage --json`` (runs and calls per tool as
     counted from the DB's TrajectoryRecords, spans per tool from its
     ToolTraceRecords) and ``db_dump --clear
     evaluation_samples`` on a copy given 8 more samples (all cleared, the
     other tables as they were);
  4i. the API on the card: whether tornado imports on this host is printed;
     without it the HTTP/SSE routes (create_app, serve_api) cannot run, and
     the phase says so. ``ApiState()`` (no device: the card) and a CPU twin
     (``device="cpu"``) take the calls the routes make: 512 of 4f's files
     through the file store and one staged build into a KB the state
     creates (on the card; the twin's chunk count; the same files again all
     skipped, no row added); 64 fact questions through ``kb.search`` and
     the hybrid retriever (the query route's dense and hybrid calls): one
     topk_pruned launch each, each fact's document in its hybrid top 5,
     every list the twin's up to near-ties within TOL, host-clock medians
     and the scan's device time; the KB saved where the snapshot route
     saves it and a new ``ApiState()`` on the same data dir, which
     rehydrates it on the card and answers 8 queries with the same rows and
     scores; with memory on, ``get_agent`` and the memory routes' toolkit
     on the card, 256 memories added and 16 searches equal to the twin's,
     every hit the asking user's;
  4j. the DTR Excel agent and the eval harness on the card (whether
     matplotlib imports on this host is printed): (a) the committed DTR
     fixture's (benchmarks/data/dtr/) first four questions of each kind in
     file order (23) through the linear, mcts and autonomous planners of
     the ``ExcelAgent`` that ``get_agent`` builds from
     ``examples/excel_qa`` on the card, with the scripted analyst of
     ``bench/dtr.py`` and a ``VectorMemoryToolkit`` on the card for
     experience priming, against a CPU twin: every answer, plan, code
     string and event sequence and each planner's accuracy the twin's, no
     answer an error, every question's hit the fixture's known outcome
     (linear misses the four "hard" questions, mcts and autonomous none;
     the chart kind is excused, and the exemption printed, where
     matplotlib is missing), ``search_skills`` on topk_pruned (calls and
     launches printed); (b)
     ``wb_sales``'s schema drawn at 100,000 ``orders`` rows, 8 aggregate,
     superlative and join questions through the linear planner, each
     answer holding its pandas gold value, the median seconds a question
     and its sandbox share; (c) the agent on ``yrt_tiny_chat`` on the
     card: the run ends, the first generate's greedy tokens are a CPU
     twin's, tokens/s; (d) ``RetrievalBenchmark`` on 4i's KB and its twin
     (64 qrels, dense and hybrid) and on an int8 KB of the asked
     documents: the twin's metrics, lists equal up to near-tie swaps
     within TOL (printed), launches beside ``batch_retrieve`` calls; (e)
     ``BaseBenchmark`` as ``run_eval`` drives it over those 64 facts (a
     ``simple`` agent with the KB toolkit on 4i's KB, a scripted model,
     ``exact_match``): the twin's stats, 64 samples judged in sqlite, one
     launch a sample, the host-clock ms a sample;
  4k. the MCP tool server on the card (``start_tools_mcp``): (a) in process,
     a router over ``rag`` and ``codesnip`` with no device (the card) and a
     CPU twin (``--device cpu``'s config), driven only through
     ``handle_message``: initialize, tools/list (the four rag tools and
     run_snippet), one rag_build of MCP_DOCS short fact documents and
     MCP_QUESTIONS rag_retrieve calls: each fact's document in its top 5,
     exactly one topk_pruned launch a retrieve, the twin's text (or, where
     the text differs, the twin's hits up to near-ties within TOL),
     run_snippet ``print(7*6)`` gives "42", an unknown method -32601; the
     same questions on a build of MCP_STDIO_DOCS of them in process (one
     launch each); (b) the port's ``MCPToolkit`` over stdio against ``python
     -m youtu_rag_tpu_torch.start_tools_mcp --toolkits rag codesnip`` on the
     card: its start-up time, phase 2's kernel libraries loaded and none
     built, the MCP_STDIO_DOCS build's answers equal to (a)'s in-process
     ones; (c) whether tornado imports is printed: without it the SSE
     transport cannot run here (the CPU tests hold it); host-clock medians
     of a retrieve in process and over stdio, the scan's device time;
  5. main path, full size: 1,048,576 × 768 cosine indexes of each tier
     filled through ``add`` from one set of seeded vectors, searched with
     q = 8, top_k = 10 (int4 asks its kernel for 64 candidates and
     re-ranks them on the host), checked against the plain versions on the
     same device tensors, and timed with CUDA events beside their bounds,
     the plain versions, a one-call PyTorch yardstick where one exists and
     the recorded time of the kernel's earlier design (EARLIER_MS), and
     each call's device time split by kernel (torch.profiler; where it
     lost records, the call's CUDA graph and its held time instead); every
     tier at k = 10, 64, 256 and 1024, each beside its bound and the
     PyTorch call's time at that k, and one call's CUDA graph per tier: one
     ring kernel after its memset (no merge launch, no host cast or
     quantization of the queries, no sort); then rows 1-2 at the main
     path's other shapes (BRUTE_SHAPES: 4g's filtered memory index, a 5f
     shard, 4k's MCP knowledge base), held to their plain versions and timed
     (held, L2 cold past its size) beside their bounds and PyTorch's;
  5c. main path, full size, IVF: ``configs/rag/ivf_int8.yaml``'s index
     settings (block_rows 1024, n_lists 1024, n_probe 64, adaptive margin
     0.15, recall target 0.95) over 1,048,576 × 768 clustered unit vectors
     drawn on the card (``scripts/bench_scale.py``'s generator: 1024
     centers, spread 0.7), one index per tier: ``build_ivf`` timed, a
     q = 8, top_k = 10 search checked against the plain version on the same
     plan, recall@10 against the brute kernel, the IVF kernel timed beside
     its bound (the probed bytes), its plain version and the brute kernel,
     one call's launches (1) and five calls' device kernels (the scan
     alone, after a memset), the search's device time split by
     torch.profiler (no merge kernel); then again with the adaptive margin
     off (a fixed n_probe 64 plan); each beside the earlier design's
     recorded time (EARLIER_MS, EARLIER_FIXED_MS);
  5d. the ops path at full size, on phase 5's and 5c's device tensors:
     ``fused_topk(q, x_bf16, bias, 10)`` (backend "auto", which must take
     the kernel), ``topk_int8`` at block_rows 2048, and ``ivf_topk`` /
     ``ivf_topk_int8`` on 5c's adaptive plan at its block_rows 1024; each
     checked against its plain version (merged and as candidates) and, on
     its live slots, against the pruned or DMA kernel on the same tensors
     (int8 the same rows and score bits; bf16, which sums on the tensor
     cores, as compare_topk holds two bf16 results); then each merged call
     is one kernel and no sort (the host's torch.sort refused, the kinds
     torch.profiler records, the call's CUDA graph: one memset and one
     ``ivf_tma_kernel``), timed (held timer, L2 cold) beside its bound
     (brute phase 5's: the rows read once and the result; IVF the probed
     rows), the earlier design (the candidates kernel and merge_blocks:
     "kernel + merge") and its kernel alone, the plain version, and brute
     the pruned kernel and a one-call PyTorch yardstick, IVF the DMA kernel
     on the same plan; each call's gates and timings take seconds printed;
  5f. main path, full size, sharded over a mesh (``parallel.mesh``, a
     local mesh of 4 shards on the card unless named): (a) phase 5's
     1,048,576 x 768 rows per tier in a ShardedVectorIndex, the unsharded
     index's hits (bf16 within TOL, int8 and int4 bit-equal), 4 launches a
     search, the search's device time (the 4 kernels and the merge) beside
     the unsharded kernel on the same rows, its bound and the merge's
     share; (b) configs/rag/ivf_int8.yaml's index (read by ConfigLoader,
     held equal to IVF_SETTINGS) over 5c's clustered rows per tier, filtered
     (part 0, which every 8th row's metadata names) and not: 4 DMA-kernel
     launches a search, every filtered hit of part 0, recall@10 against the sharded brute search within 0.02 of 5c's
     unsharded recall; (c) appends past two capacity doublings, deletes,
     compact() and a save / load_index(mesh=...) round trip, bf16 and int8,
     the hits of an unsharded twin after every step; (d) ApiState(mesh=...)
     builds 512 of 4f's files (hash provider): each fact's document in its
     hybrid top 5, the dense lists 4i's unsharded KB's up to near-ties, a
     restart reloading the snapshot sharded, then the encoder provider
     through the mesh's data-parallel embedder (dp 4, T = 256): on one
     card its 4 slices share the device, so this checks the padding to a
     multiple of dp and the one merged forward, bit-equal to the
     undistributed embedder's (the CPU tests hold the split across
     devices); (e) a NCCL
     process group of one (init_process_group, a HashStore) and a group
     mesh over it: a 262,144-row bf16 index grown through the ring, the
     local mesh's hits bit for bit; (f) tp 2 at Qwen2-0.5B's widths (6b's
     seeded weights): 32 greedy tokens of 2 prompts of 512 in f32 (TF32
     off) equal to the replicated run's, the bf16 first step within
     BF16_TOL, ms a decode step beside the replicated run's;
  5b. main path, full size, encoder: the default encoder embeds 128 texts
     at T = 512 (embeddings/s, the forward's device time and its split by
     kernel), and the same encoder with max_len 8192 embeds two long
     documents at T = 8192 (flash; the forward of the two, B = 2, timed
     and split by kernel); each kernel, on the last layer's
     tensors of its run, is held against its plain version and timed
     beside its bound, its plain version and scaled_dot_product_attention
     (the kernel and SDPA by two timers: time_ms, bursts of calls, and
     time_held_ms, one call's device time behind a spin of the card);
  5e. main path, full size, the ring: the default encoder with sp_mesh=4
     embeds 8 documents of ~3,500 words (T 4096, Tl 1024): embeddings/s,
     the forward's device time and its split by kernel, the same top-1
     neighbours as the unsharded forward at T = 4096 (blockwise) within
     ENC_TOL, and in f32 at T = 2048 within 2e-5; the hop kernel on the
     main path's tensors, then at [2, 12, 8192, 64] bf16 against 8192 keys
     (sp 4 over T = 32,768) timed beside its bound, its plain version, the
     efficient-attention call that returns (out, logsumexp) and EARLIER_MS;
  6a. the local LLM, the agentic CLI: ``python -m
     youtu_rag_tpu_torch.cli_chat --llm-weights-dir
     benchmarks/models/yrt_tiny_chat`` in this process over twelve fact
     documents in the chat model's training format (its own copy of the
     generator), three questions on its standard input: no turn may report
     an error, each first turn must be a kb_embedding_search action, every
     observation the model is given must be a search result, the KB's
     search must launch topk_pruned, and an answer must come back; the same
     toolkit, asked each question itself, must return the fact document
     the question was made from; then the same on the CPU (``--device
     cpu``, no error either), and whether transcripts and observations are
     equal;
  6b. the local LLM at Qwen2-0.5B's widths (Qwen/Qwen2-0.5B-Instruct's
     config.json, random bf16 weights written from the seed as a qwen2
     safetensors checkpoint, loaded by ``load_pretrained_decoder`` with
     max_len 2048, served in bf16): gates (calibrated on the card at full
     depth against controls by ``python -m
     youtu_rag_tpu_torch.bench.decoder_tolerance``) on decode with the
     cache against the teacher-forced forward, the int8 KV cache against
     the bf16 one and the first step against the CPU f32 forward (B 1,
     T 128); prefill at T = 512 and decode over 128 new tokens at B = 1
     and 8 (bf16 and int8 caches) beside the bytes bound, generate's
     tokens/s, a decode step's device split (torch.profiler) and the
     host's cost of generate's per-step read-back of ``done``;
  6c. training on the card (no kernel: the attention kernels refuse a
     differentiable call, and the trainers take plain attention): (a)
     ``train_embedder.main`` in this process at the default EncoderConfig
     (768 x 12, vocab 32,768, bf16 activations, f32 master weights) with
     ``--synthetic 512 --siblings 4 --paraphrase 2048``, B = 64, T = 128,
     TRAIN_STEPS steps, checkpoints at 100 and TRAIN_STEPS: every loss finite, the last 20
     steps' mean below the first 20's, holdout recall@1 higher after than
     before, no attention launch while training; step 100 restored
     bit-equal (parameters, moments, count) and 5 resumed steps on the
     uninterrupted run's batches 101-105 giving its parameters within
     RESUME_RTOL; a step's device split (torch.profiler); one step's gradients at step
     100's parameters in f32 with TF32 off against a CPU f32 twin (B 8,
     T 64) within GRAD_RTOL; ms a step (median and spread), tokens/s and
     the model FLOPs' time at peak; (b) the saved directory served by
     TorchEmbedder with "pallas": 64 of 4f's documents at T = 512 with
     blockwise launches a positive multiple of 12, 16 of them within
     FT_ENC_TOL of the CPU f32 forward; a KB over the holdout positives, one
     topk_pruned launch or more per holdout query, whose recall@1 is
     eval_recall's up to near-ties within TIE_TOL; (c) make_moe_train_step
     at the same widths with 8 experts, 3 steps: losses and aux losses
     finite, the experts' token shares; (d) ``train_chat_lm.main`` at
     yrt_tiny_chat's widths (d 192, 6 layers, vocab 2,048), CHAT_LM_STEPS
     at B = 32 (cut from 400, then 200, to keep 6c within its time): the
     loss falls, the evaluation reported, and its outputs
     through ``cli_chat --llm-weights-dir`` answer a question without
     error; (e) make_lm_train_step at Qwen2-0.5B's widths (f32 parameters
     from the seed, bf16 activations), B = 4, T = 512, 5 steps on one batch
     with remat (the loss finite and falling), then 2 without: ms a step,
     tokens/s, the model FLOPs' time at peak, peak memory of each;
  6d. training and inference over a mesh, every mesh a local one whose
     slots are the card: (0) allow_tf32 set True survives a brute and an
     IVF search, an f32 encoder forward and a k-means fit; (a)
     make_sharded_train_step over dp 2 x tp 2 at the default widths, B 64,
     T 128, against make_train_step: one f32 step (TF32 off) with its loss
     within MESH_LOSS_RTOL, its gradients within GRAD_RTOL of each leaf's
     largest and its parameters' changes within MESH_FLIP_SHARE, then 3
     bf16-activation steps of each (ms a step, peak memory, the replicas
     bit-equal); (b) make_sharded_moe_train_step over dp 2 x ep 4, 8
     experts, the same gates and aux_loss > 0; (c)
     make_sharded_lm_train_step over dp 2 x tp 2 at Qwen2-0.5B's widths, B
     4, T 512, remat, 2 f32 steps (completions of unequal counts) and 2 bf16
     ones; (d) make_pp_encoder, S 4 x 3 layers, M 8, B 32, T 512, "pallas",
     against encode_tokens within ENC_TOL, blockwise launches M·L from the
     schedule; (e) make_ep_encoder and make_ep_encoder_a2a (dropless), 8
     experts over ep 4, B 16, T 512, against moe_encode_tokens, 12
     blockwise launches each; (f) make_sp_encoder over dp 1 x sp 4 x tp 2 on
     5e's documents at T 4096 against 5e's unsharded forward, hop launches
     layers x tp x sp; (g) ``train_embedder.main --dp 2 --tp 2``, 10 steps
     at the small preset, its npz served; (h) ``dryrun_multichip(4)`` on four slots of the card;
  7. one JSON line, {"kernels": [{"name": ..., "route", "source",
     "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
     "bound_by", "library_ms"}, ...]}: one entry per kernel, thirteen;
  8. the last line: {"ok": true, "device": {...}}.

The main path's launch counts are set to 0 just before phases 2b, 4, 4b (a),
4c, 4d, 4e, 4f (a) and (c), 4g (a) and (b), each run of 4h (a) and (d), each
search batch of 4i, 4j (a), (d) and (e), 5, 5c, 5d, 5f (a)-(e), 5b, 5e, 6a, 6c (b) and
(d) and 6d (d)-(f) and (h) drive it
and read just after; launches
made to compare or time a kernel are not counted. An index's tier
warm-up launches the brute scans too, on the writer in ``add`` before a
growth (``ensure_tier_ready``): the wrappers count those launches in the
phase that drives the ``add``. Its background thread loads a library and
launches nothing. Every phase prints its wall time.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import importlib
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

TOL = 1e-4  # bf16: unit vectors, f32 sums in another order than cuBLAS
ROWS = 1 << 20  # the full-size indexes: 1,048,576 × 768
HBM_PEAK = {"sxm": 3.35e12, "pcie": 2.0e12}  # bytes/s, NVIDIA data sheets
BF16_PEAK = {"sxm": 989e12, "pcie": 756e12}  # dense tensor-core flop/s
INT8_PEAK = {"sxm": 1979e12, "pcie": 1513e12}  # dense tensor-core op/s
TIERS = ("bfloat16", "int8", "int4")
KERNEL_NAMES = {"bfloat16": "topk_pruned", "int8": "topk_int8_pruned", "int4": "topk_int4_pruned"}
ATTENTION_NAMES = ("blockwise_attention", "flash_attention")
IVF_NAMES = {"bfloat16": "ivf_topk_dma", "int8": "ivf_topk_int8_dma", "int4": "ivf_topk_int4_dma"}
BLOCKS_NAMES = ("topk", "topk_int8", "ivf_topk", "ivf_topk_int8")
REPLACES = {  # the pallas_call of each TPU kernel
    "topk_pruned": "youtu_rag_tpu/ops/topk.py:299",
    "topk_int8_pruned": "youtu_rag_tpu/ops/topk.py:494",
    "topk_int4_pruned": "youtu_rag_tpu/ops/topk.py:665",
    "blockwise_attention": "youtu_rag_tpu/ops/attention.py:80",
    "flash_attention": "youtu_rag_tpu/ops/attention.py:307",
    "flash_attention_stats": "youtu_rag_tpu/ops/attention.py:229",
    "ivf_topk_dma": "youtu_rag_tpu/ops/ivf.py:461",
    "ivf_topk_int8_dma": "youtu_rag_tpu/ops/ivf.py:527",
    "ivf_topk_int4_dma": "youtu_rag_tpu/ops/ivf.py:596",
    "topk": "youtu_rag_tpu/ops/topk.py:174",
    "topk_int8": "youtu_rag_tpu/ops/topk.py:407",
    "ivf_topk": "youtu_rag_tpu/ops/ivf.py:103",
    "ivf_topk_int8": "youtu_rag_tpu/ops/ivf.py:188",
}
# one nvcc each, all started together (build_all); the ring one source per tier
SOURCES = ("ivf_topk_bf16", "ivf_topk_int8", "ivf_topk_int4", "attention", "topk_blocks")
# Each redesigned kernel's time before its redesign, as PERF.md §6 records
# it (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W): the hop on the
# mma.sync kernel at [2, 12, 8192, 64] against 8192 keys; the brute scans on
# topk_select.cuh's scan with a merge launch after it (bf16 and int8 at k =
# 10 on the CUDA-core scorers; int4 at k = 64 on the tensor-core scorer);
# the IVF scans on topk_select.cuh's scan with a merge launch after it
# (phase 5c's adaptive plan; int4 with the tensor-core scorer, k = 64).
EARLIER_MS = {"flash_attention_stats": 1.9755, "topk_pruned": 0.6301,
              "topk_int8_pruned": 0.4068, "topk_int4_pruned": 0.3314,
              "ivf_topk_int4_dma": 0.1544, "ivf_topk_dma": 0.0918, "ivf_topk_int8_dma": 0.0879}
# ... and the IVF scans' on phase 5c's fixed plan
EARLIER_FIXED_MS = {"ivf_topk_dma": 0.4670, "ivf_topk_int8_dma": 0.3168,
                    "ivf_topk_int4_dma": 0.4119}

# Phase 4g's and 4j's configs as the port's ConfigLoader composes them from
# configs/agents/memory_chat.yaml, configs/agents/meta_retrieval.yaml,
# configs/tools/text2sql.yaml and configs/agents/examples/excel_qa.yaml with
# no YRT_* variable set (a CPU test, tests/test_torch_loader.py, holds them
# equal): phases 4g and 4j build their agents from these where the card's
# host has no yaml, and say so.
_SIMPLE_BASE = {"type": "simple", "max_turns": 50,
                "model": {"model": "", "base_url": "", "api_key": ""}}
CONFIG_DICTS = {
    ("agents", "memory_chat"): {
        **_SIMPLE_BASE,
        "agent": {"name": "memory_chat", "instructions": (
            "You are a personal assistant with long-term memory. Prior context is\n"
            "injected before your instructions; use it, and prefer remembered user\n"
            "preferences over generic defaults.\n")},
        "memory": {"enabled": True, "user_id": "default", "max_context_items": 8},
        "toolkits": {"memory": {"name": "memory", "mode": "builtin"}},
    },
    ("agents", "meta_retrieval"): {
        **_SIMPLE_BASE,
        "agent": {"name": "meta_retrieval", "instructions": (
            "You answer time-sensitive questions over the knowledge base. Always run\n"
            "query_analysis first to extract time constraints, search with the\n"
            "produced filters, widen with expand_filter_scope if recall is thin, and\n"
            "merge_retrieval_results before answering.\n")},
        "toolkits": {"meta_retrieval": {"name": "meta_retrieval", "mode": "builtin",
                                        "config": {"kb": "default"}}},
    },
    ("tools", "text2sql"): {"name": "text2sql", "mode": "builtin",
                            "config": {"kb": "default", "database_url": ""}},
    # phase 4j's Excel agent (configs/agents/examples/excel_qa.yaml)
    ("agents", "examples/excel_qa"): {
        **_SIMPLE_BASE, "type": "excel",
        "agent": {"name": "excel_qa",
                  "instructions": "You answer analytical questions over spreadsheet data."}},
}

_phase_t0: list[tuple[str, float]] = []


def phase(name: str) -> None:
    """Start a phase; prints the wall time of the one before."""
    now = time.perf_counter()
    if _phase_t0:
        prev, t0 = _phase_t0[-1]
        print(f"-- phase {prev}: {now - t0:.1f} s wall", flush=True)
    _phase_t0.append((name.split()[0], now))
    print(f"== {name}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def ops():
    """The port's kernels by tier: (wrapper, plain version, quantizer)."""
    # by its path: youtu_rag_tpu_torch.ops.topk is also the name of a function
    t = importlib.import_module("youtu_rag_tpu_torch.ops.topk")

    return {
        "bfloat16": (t.topk_pruned, t.topk_pruned_reference, None),
        "int8": (t.topk_int8_pruned, t.topk_int8_pruned_reference, t.quantize_rows_int8),
        "int4": (t.topk_int4_pruned, t.topk_int4_pruned_reference, t.quantize_rows_int4),
    }


def attention_ops():
    """The attention kernels by name: (wrapper, plain version)."""
    from youtu_rag_tpu_torch.ops import attention as a

    return {"blockwise_attention": (a.blockwise_attention, a.blockwise_attention_reference),
            "flash_attention": (a.flash_attention, a.flash_attention_reference),
            "flash_attention_stats": (a.flash_attention_stats, a.flash_attention_stats_reference)}


def ivf_ops():
    """The port's IVF kernels by tier: (wrapper, plain version, quantizer)."""
    v = importlib.import_module("youtu_rag_tpu_torch.ops.ivf")
    t = importlib.import_module("youtu_rag_tpu_torch.ops.topk")

    return {
        "bfloat16": (v.ivf_topk_dma, v.ivf_topk_dma_reference, None),
        "int8": (v.ivf_topk_int8_dma, v.ivf_topk_int8_dma_reference, t.quantize_rows_int8),
        "int4": (v.ivf_topk_int4_dma, v.ivf_topk_int4_dma_reference, t.quantize_rows_int4),
    }


def blocks_ops():
    """The per-block kernels by name: (wrapper, plain version, tier, takes a plan)."""
    v = importlib.import_module("youtu_rag_tpu_torch.ops.ivf")
    t = importlib.import_module("youtu_rag_tpu_torch.ops.topk")

    return {"topk": (t.topk, t.topk_reference, "bfloat16", False),
            "topk_int8": (t.topk_int8, t.topk_int8_reference, "int8", False),
            "ivf_topk": (v.ivf_topk, v.ivf_topk_reference, "bfloat16", True),
            "ivf_topk_int8": (v.ivf_topk_int8, v.ivf_topk_int8_reference, "int8", True)}


def settle_warm() -> None:
    """Wait for the indexes' background tier warms (threads "yrt-warm-<cap>",
    which build and load a kernel library)."""
    for t in threading.enumerate():
        if t.name.startswith("yrt-warm-"):
            t.join(300)
            check(not t.is_alive(), f"the tier warm {t.name} still runs after 300 s")


def reset_launches() -> None:
    for wrapper, _, _ in [*ops().values(), *ivf_ops().values()]:
        wrapper.launches = 0
    for wrapper, _ in attention_ops().values():
        wrapper.launches = 0
    for wrapper, *_ in blocks_ops().values():
        wrapper.launches = 0


def blocks_counts() -> dict[str, int]:
    return {name: wrapper.launches for name, (wrapper, *_) in blocks_ops().items()}


def launch_counts() -> dict[str, int]:
    return {tier: wrapper.launches for tier, (wrapper, _, _) in ops().items()}


def ivf_counts() -> dict[str, int]:
    return {tier: wrapper.launches for tier, (wrapper, _, _) in ivf_ops().items()}


def attention_counts() -> dict[str, int]:
    return {name: wrapper.launches for name, (wrapper, _) in attention_ops().items()}


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def build_all() -> None:
    """One nvcc per source, all started together."""
    from youtu_rag_tpu_torch.ops import _build

    done: dict[str, dict | BaseException] = {}

    def run(name):
        try:
            done[name] = _build.build(name, verbose=True)
        except BaseException as e:  # re-raised below, in the main thread
            done[name] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(n,)) for n in SOURCES]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for name in SOURCES:
        got = done[name]
        if isinstance(got, BaseException):
            raise SystemExit(f"FAIL: build of {name}: {got}")
        print(f"built {name} in {got['seconds']:.1f} s")
        print("\n".join(line for line in got["log"].splitlines()
                        if any(w in line for w in ("registers", "stack", "Compiling entry",
                                                   "warning"))))
    print(f"all builds: {time.perf_counter() - t0:.1f} s wall")
    from youtu_rag_tpu_torch.bench.ab_kernels import ptxas_report

    for name in ("attention", "ivf_topk_bf16", "ivf_topk_int8", "ivf_topk_int4"):
        for kernel, regs, spills in ptxas_report(done[name]["log"]):
            if kernel.startswith(("attention", "ivf_tma")):
                print(f"  {name}: {kernel}: {regs} registers, spill stores/loads {spills}")


# the (d, k) grid of the TMA IVF entries' shared-memory plans (int4 takes
# d % 256 == 0: its first width is 256)
PLAN_WIDTHS = (128, 768, 1024, 2048, 4096, 8192)
PLAN_KS = (1, 10, 128, 1024, 2048, 4096, 8192)  # 8192: phase 3x's int8 BIG_K
TMA_ENTRIES = ("ivf_topk_bf16", "ivf_topk_int8", "ivf_topk_int4", "ivf_blocks_bf16",
               "ivf_blocks_int8")


def ivf_plan_table() -> None:
    """Per TMA IVF entry of csrc/ivf_topk_<tier>.cu and (d, k): the CTAs one SM
    holds (``<entry>_ctas_per_sm``, before the wrapper's cap of 2) and the
    plan, rows x stages, "dev" where the lists live in device memory and
    "wide" where the query tile does. Fails where a cell has no plan."""
    from youtu_rag_tpu_torch.ops.topk import _tma_library, scan_plan

    print("IVF TMA plans, ctas_per_sm/rows x stages[ dev][ wide], k across:",
          " ".join(str(k) for k in PLAN_KS))
    for entry in TMA_ENTRIES:
        for d in PLAN_WIDTHS:
            if entry.endswith("int4") and d == 128:
                d = 256
            cells = []
            for k in PLAN_KS:
                per_sm = getattr(_tma_library(entry), f"{entry}_ctas_per_sm")(d, k)
                rows, stages, dev, wide = scan_plan(entry, d, k)
                check(per_sm >= 1 and rows > 0, f"{entry} d={d} k={k}: no plan ({per_sm})")
                cells.append(f"{per_sm}/{rows}x{stages}{' dev' if dev else ''}"
                             f"{' wide' if wide else ''}")
            print(f"  {entry} d={d}: " + ", ".join(cells))


# ---------------------------------------------------------------------------
# 2b. the index's tier warm-up
# ---------------------------------------------------------------------------

WARM_ROWS = 1 << 19  # 2b fills 524,288 rows, then grows the index to 1,048,576
WARM_GROW = 1 << 16  # the append that grows it
WARM_STEADY = 5  # searches after the first two, for the steady time


def search_ms(index, queries, top_k: int = 10):
    """(the hits, the wall time of one search in ms: host prep, the launch
    under the index lock, the results back on the host)."""
    t0 = time.perf_counter()
    hits = index.search(queries, top_k=top_k)
    return hits, (time.perf_counter() - t0) * 1e3


def tier_warm_up(seed: int, smi: str) -> dict:
    """2b: per tier a never-warmed index (``ColdIndex``: the warm-up's two
    entry points are no-ops) and a warmed one, in a process that has loaded
    no ring library yet: bf16 cold first, int8 warm first. Each fills
    WARM_ROWS × 768 rows at capacity WARM_ROWS (the warmed one's background
    warm loads its tier's library at 75 %), searches q = 1 and 8 at k 10
    (the signatures; the warmed one's thread marks them warmed at 1,048,576),
    grows by WARM_GROW rows (the warmed one runs ``ensure_tier_ready`` first)
    and searches again. Returns the phase's launches by tier, those of
    ``ensure_tier_ready`` among them."""
    from youtu_rag_tpu_torch.core.config import IndexConfig
    from youtu_rag_tpu_torch.index.device_index import DeviceVectorIndex
    from youtu_rag_tpu_torch.ops import _build
    from youtu_rag_tpu_torch.ops.topk import _TMA_ENTRY, _TMA_LIB
    from youtu_rag_tpu_torch.utils.provenance import run_provenance

    class ColdIndex(DeviceVectorIndex):
        def _maybe_warm_next_tier(self) -> None:
            return

        def ensure_tier_ready(self, cap: int) -> None:
            return

    prov = run_provenance(seed)["provenance"]
    print(f"provenance: {json.dumps(prov)}")
    check(prov["device_name"] == torch.cuda.get_device_name(0) and prov["card"] == smi,
          f"provenance names {prov.get('device_name')!r} / {prov.get('card')!r}, not {smi!r}")
    d, batch, rows, cap = 768, 65536, WARM_ROWS, 2 * WARM_ROWS
    t0 = time.perf_counter()
    vecs, chunks, queries = full_size_data(seed, rows + WARM_GROW, d, 8)
    top_row = f"c{(rows + WARM_GROW) // 2}"
    print(f"{rows + WARM_GROW} x {d} unit vectors made in {time.perf_counter() - t0:.1f} s")
    kernels = ops()
    reset_launches()
    for tier, arms in (("bfloat16", ("cold", "warm")), ("int8", ("warm", "cold"))):
        kernel = kernels[tier][0]
        lib = _TMA_LIB[_TMA_ENTRY[kernel.__name__]]
        hits = {}
        for arm in arms:
            cls = DeviceVectorIndex if arm == "warm" else ColdIndex
            index = cls(d, IndexConfig(storage_dtype=tier, min_capacity=rows), device="cuda")
            loaded = [_build.is_loaded(lib)]
            t0 = time.perf_counter()
            for start in range(0, rows, batch):
                index.add(chunks[start : start + batch], vecs[start : start + batch])
            torch.cuda.synchronize()
            settle_warm()
            fill_s = time.perf_counter() - t0
            loaded.append(_build.is_loaded(lib))
            first = {qn: search_ms(index, queries[:qn])[1] for qn in (1, 8)}
            settle_warm()  # the warmed index's thread loads nothing new here
            before = kernel.launches
            t0 = time.perf_counter()
            index.add(chunks[rows:], vecs[rows:])
            torch.cuda.synchronize()
            grow_ms = (time.perf_counter() - t0) * 1e3
            ensure = kernel.launches - before  # ensure_tier_ready's, on this thread
            check(index.capacity == cap, f"2b {tier} {arm}: capacity {index.capacity}")
            after, steady = {}, {}
            for qn in (1, 8):
                got, after[qn] = search_ms(index, queries[:qn])
                hits[arm, qn] = hit_lists(got)
                steady[qn] = statistics.median(search_ms(index, queries[:qn])[1]
                                               for _ in range(WARM_STEADY))
                check(got[0][0][0].id == top_row, f"2b {tier} {arm}: query 0's top hit "
                      f"{got[0][0][0].id}, not {top_row}")
                check(len(got) == qn and all(len(h) == 10 for h in got)
                      and all(np.isfinite(sc) for h in got for _, sc in h),
                      f"2b {tier} {arm} q={qn}: wrong shape or a non-finite score")
            print(f"{tier} {arm}: library {lib} loaded before the fill {loaded[0]}, after it "
                  f"{loaded[1]}; filled {rows} rows in {fill_s:.1f} s; first searches of the "
                  f"index q=1 {first[1]:.3f} ms, q=8 {first[8]:.3f} ms; growth to {cap} rows "
                  f"{grow_ms:.1f} ms ({ensure} warm launches in it); first search after the "
                  f"growth q=1 {after[1]:.3f} ms, q=8 {after[8]:.3f} ms; then the median of "
                  f"{WARM_STEADY} q=1 {steady[1]:.3f} ms, q=8 {steady[8]:.3f} ms; {smi}")
            if arm == "warm":
                check(loaded[1], f"2b {tier}: the warm-up left {lib} unloaded after the fill")
                check(ensure == 2, f"2b {tier}: ensure_tier_ready made {ensure} launches, not 2")
                want = {(cap, ("sig", (qn, 10, "auto"))) for qn in (1, 8)}
                check(want <= index._warmed, f"2b {tier}: warmed {sorted(index._warmed)}")
            else:
                check(ensure == 0 and not index._warmed, f"2b {tier}: the cold index warmed")
            del index
            torch.cuda.empty_cache()
        for qn in (1, 8):
            check(hits["warm", qn] == hits["cold", qn],
                  f"2b {tier} q={qn}: the warmed index's hits differ from the cold one's")
        print(f"{tier}: after the growth, warmed and cold hits are equal (ids and scores, bit "
              f"for bit) at q = 1 and 8")
    counts = launch_counts()
    print(f"2b launches {counts} (ensure_tier_ready's among them)")
    check(counts["bfloat16"] > 0 and counts["int8"] > 0, f"2b launches {counts}")
    return {"launches": counts}


# ---------------------------------------------------------------------------
# 3. kernel vs plain
# ---------------------------------------------------------------------------

KERNEL_CASES = [
    (q, d, n, k)
    for q in (1, 8, 64)
    for d in (256, 768)
    for n in (4096, 65536)
    for k in (1, 10, 50, 128, 256, 1024)
]
# the int4 kernel alone (the ring's 64-row stages, 16-row warp groups): d
# 256 (one half-round of chunks) and 4096 (eight rounds), row counts that
# are not a multiple of 64 or 16 (the last stage partly past the end, its
# rows not a multiple of 4: bias and scales by element copies)
INT4_CASES = [(q, d, n, k) for q in (1, 8, 64) for d in (256, 4096) for n in (4099, 20011)
              for k in (1, 64, 1024)]


def compare_live(got, want, full_scores, what: str) -> float:
    """bf16, live slots only: equal row sets (rows whose scores sit within
    TOL of the k-th may swap) and scores within TOL. Returns the max abs
    score error."""
    from youtu_rag_tpu_torch.ops.topk import NEG_INF

    gs, gi = (t.cpu() for t in got)
    ws, wi = (t.cpu() for t in want)
    err = 0.0
    for a in range(ws.shape[0]):
        live = ws[a] > NEG_INF / 2
        n_live = int(live.sum())
        check(int((gs[a] > NEG_INF / 2).sum()) == n_live, f"{what}: live slot count, query {a}")
        if n_live == 0:
            continue
        e = float((gs[a, :n_live] - ws[a, :n_live]).abs().max())
        check(e <= TOL, f"{what}: score error {e} > {TOL}, query {a}")
        err = max(err, e)
        diff = set(gi[a, :n_live].tolist()) ^ set(wi[a, :n_live].tolist())
        kth = float(ws[a, n_live - 1])
        near = all(abs(float(full_scores[a, r]) - kth) <= TOL for r in diff)
        check(near, f"{what}: row sets differ beyond near-ties, query {a}: {sorted(diff)[:8]}")
    return err


def compare_topk(got, want, full_scores, what: str) -> float:
    """compare_live, and the kernel's own ties in row order."""
    from youtu_rag_tpu_torch.ops.topk import NEG_INF

    err = compare_live(got, want, full_scores, what)
    gs, gi = (t.cpu() for t in got)
    for a in range(gs.shape[0]):
        for t in range(int((gs[a] > NEG_INF / 2).sum()) - 1):
            if gs[a, t] == gs[a, t + 1]:
                check(int(gi[a, t]) < int(gi[a, t + 1]), f"{what}: tie not in row order, query {a}")
    return err


def compare_exact(got, want, what: str) -> float:
    """int8 / int4, live slots only: the same rows in the same order and
    bit-equal scores. Returns the max abs score error (0.0)."""
    from youtu_rag_tpu_torch.ops.topk import NEG_INF

    gs, gi = (t.cpu() for t in got)
    ws, wi = (t.cpu() for t in want)
    for a in range(ws.shape[0]):
        n_live = int((ws[a] > NEG_INF / 2).sum())
        check(int((gs[a] > NEG_INF / 2).sum()) == n_live, f"{what}: live slot count, query {a}")
        check(torch.equal(gi[a, :n_live], wi[a, :n_live]), f"{what}: rows differ, query {a}")
        check(torch.equal(gs[a, :n_live].view(torch.int32), ws[a, :n_live].view(torch.int32)),
              f"{what}: scores not bit-equal, query {a}")
    return 0.0


def plain_scores(queries, x, bias):
    return queries.to(torch.bfloat16).float() @ x.float().T + bias[None, :]


def kernel_cases(seed: int) -> dict[str, float]:
    from youtu_rag_tpu_torch.ops.topk import NEG_INF

    g = torch.Generator(device="cuda").manual_seed(seed)

    def unit(rows, d):
        v = torch.randn(rows, d, generator=g, device="cuda")
        return v / v.norm(dim=1, keepdim=True)

    cases = [(c, "mixed") for c in KERNEL_CASES]
    cases += [((8, 256, 4096, 10), "all_masked"), ((64, 768, 65536, 1024), "all_masked")]
    # row counts that split into CTA ranges, 128-row tiles and 4-row groups unevenly
    cases += [((8, 768, 100003, 50), "mixed"), ((3, 256, 4099, 256), "mixed")]
    max_err = {tier: 0.0 for tier in TIERS}
    for (q, d, n, k), kind in cases:
        x = unit(n, d)
        x[100:110] = x[5]  # duplicated rows: exact ties
        queries = unit(q, d)
        queries[0] = x[5]  # the ties land at the top of query 0
        bias = torch.zeros(n, device="cuda")
        bias[::7] = NEG_INF  # tombstones / padding
        bias[3::11] = float("-inf")  # NEG_INF + a filter's NEG_INF
        bias[104] = NEG_INF  # one duplicate masked
        if kind == "all_masked":
            bias[:] = NEG_INF
        live = bias.cpu() == 0
        ties = [r for r in (5, *range(100, 110)) if live[r]]  # query 0's exact top
        for tier, (kernel, plain, quantize) in ops().items():
            what = f"{tier} q={q} d={d} n={n} k={k} {kind}"
            if quantize is None:
                xt, args = x.to(torch.bfloat16), ()
            else:
                xt, xs = quantize(x)
                args = (xs,)
            got = kernel(queries, xt, *args, bias, k)
            torch.cuda.synchronize()
            want = plain(queries, xt, *args, bias, k)
            if quantize is None:
                e = compare_topk(got, want, plain_scores(queries, xt, bias).cpu(), what)
            else:
                e = compare_exact(got, want, what)
                if kind == "mixed":
                    top = got[1][0, : min(k, len(ties))].tolist()
                    check(top == ties[: len(top)], f"{what}: tie order {top}")
            if kind == "all_masked":
                check(bool((got[0] <= NEG_INF / 2).all()), f"{what}: returned live slots")
            max_err[tier] = max(max_err[tier], e)
        torch.cuda.synchronize()
    kernel, plain, quantize = ops()["int4"]
    for q, d, n, k in INT4_CASES:
        x = unit(n, d)
        x[100:110] = x[5]
        queries = unit(q, d)
        queries[0] = x[5]
        bias = torch.zeros(n, device="cuda")
        bias[::7] = NEG_INF
        bias[3::11] = float("-inf")
        xt, xs = quantize(x)
        got = kernel(queries, xt, xs, bias, k)
        torch.cuda.synchronize()
        compare_exact(got, plain(queries, xt, xs, bias, k), f"int4 q={q} d={d} n={n} k={k}")
        ties = [r for r in (5, *range(100, 110)) if bias[r] == 0]
        top = got[1][0, : min(k, len(ties))].tolist()
        check(top == ties[: len(top)], f"int4 q={q} d={d} n={n} k={k}: tie order {top}")
    print(f"kernel vs plain: {len(cases)} cases x {len(TIERS)} kernels and {len(INT4_CASES)} "
          "int4 cases (d 256 and 4096, rows not a multiple of 16) ok, max_abs_err "
          + ", ".join(f"{KERNEL_NAMES[t]} {e}" for t, e in max_err.items()))
    return max_err


# ---------------------------------------------------------------------------
# 3b. kernel vs plain, attention
# ---------------------------------------------------------------------------

# (name, T, hd, dtype, layout): blockwise T 256 (two key tiles, fewer than
# the Hopper kernel's ring stages), 384 and 640 (tile counts the ring's
# stages do not divide); "strided" takes q, k and v as the encoder passes
# them, [B, T, H, hd] viewed through transpose(1, 2)
ATTN_CASES = [
    (name, t, hd, dtype, "contiguous")
    for name, ts in (("blockwise_attention", (256, 384, 512, 640, 4096)),
                     ("flash_attention", (4224, 8192)))
    for t in ts
    for hd in (64, 128)
    for dtype in (torch.bfloat16, torch.float32)
] + [
    (name, t, hd, dtype, "strided")
    for name, t in (("blockwise_attention", 512), ("flash_attention", 4224))
    for hd in (64, 128)
    for dtype in (torch.bfloat16, torch.float32)
]


def attention_inputs(b: int, h: int, t: int, hd: int, dtype, g, layout: str = "contiguous"):
    """q, k, v on the card and the encoder's -1e9 padding bias: row 0
    padded past t/2 + 3, the last batch row fully masked. "strided": q, k
    and v are [B, T, H, hd] tensors seen as [B, H, T, hd] (row stride
    H·hd), as the encoder's projections reach the kernels."""
    if layout == "strided":
        q, k, v = (torch.randn(b, t, h, hd, generator=g, device="cuda").to(dtype).transpose(1, 2)
                   for _ in range(3))
    else:
        q, k, v = (torch.randn(b, h, t, hd, generator=g, device="cuda").to(dtype)
                   for _ in range(3))
    mask = torch.ones(b, t, device="cuda")
    mask[0, t // 2 + 3 :] = 0
    mask[-1] = 0
    return q, k, v, (1.0 - mask) * -1e9


def compare_attention(got, want, what: str) -> float:
    """ATTN_TOL: bf16 within one bf16 ulp of the output (rtol 2^-7, atol
    2^-10 near zero): sums in another order, and flash's 64-key tiles
    against the JAX key blocks the plain version follows, move a value
    across a bf16 rounding; f32 within 1e-5 (the kernel splits each f32
    operand into three bf16 terms and sums the products in another order).
    Any NaN fails. Returns the max abs error."""
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(got.dtype == want.dtype and got.shape == want.shape, f"{what}: dtype or shape")
    g, w = got.float(), want.float()
    rtol, atol = (2**-7, 2**-10) if got.dtype == torch.bfloat16 else (1e-5, 1e-5)
    bad = (g - w).abs() > atol + rtol * w.abs()
    err = float((g - w).abs().max())
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} outputs beyond tolerance, max {err}")
    return err


def attention_cases(seed: int) -> dict[str, float]:
    g = torch.Generator(device="cuda").manual_seed(seed)
    kernels = attention_ops()
    max_err = dict.fromkeys(kernels, 0.0)
    for name, t, hd, dtype, layout in ATTN_CASES:
        kernel, plain = kernels[name]
        args = attention_inputs(3, 2, t, hd, dtype, g, layout)
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        what = f"{name} T={t} hd={hd} {str(dtype)[6:]} {layout}"
        max_err[name] = max(max_err[name], compare_attention(got, want, what))
    print(f"attention kernel vs plain: {len(ATTN_CASES)} cases ok, max_abs_err "
          + ", ".join(f"{n} {e}" for n, e in max_err.items()))
    return max_err


# ---------------------------------------------------------------------------
# 3c. kernel vs plain, IVF
# ---------------------------------------------------------------------------

IVF_N, IVF_D = 65536, 256
IVF_CASES = [(q, k, br) for q in (1, 8, 64) for k in (1, 10, 128, 129, 1024)
             for br in (64, 1024, 4096)]
IVF_GARBAGE = 1 << 28  # an id past n_valid that points far outside the index
# the int4 kernel alone at block_rows 4, 8 and 12: its 64-row stages and
# 16-row groups straddle blocks (IVF4_N rows: a multiple of 12 and of 64)
IVF4_N = 49152
IVF4_CASES = [(q, k, br) for q in (8, 64) for k in (1, 64, 1024, 2048) for br in (4, 8, 12)]
# the three kernels (csrc/ivf_scan_tma.cuh) alone: query counts around the
# 8-query tiles and the 64 of a launch, k in the three list classes,
# block_rows 4 and 12 (a 32-row stage spans several blocks) and 4096;
# queries f32 with ids ascending, or bf16 with ids shuffled; query row 1 is
# zero (its int8 scale 1e-12 / 127)
IVF_TMA_CASES = [(q, k, br, qdtype, order) for q in (1, 7, 9, 65) for k in (1, 129, 1025)
                 for br in (4, 12, 4096) for qdtype, order in (("f32", "sorted"),
                                                              ("bf16", "shuffled"))]


def ivf_plan(n_blocks: int, n_valid: int, g, order: str = "sorted"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """A plan of max_blocks = n_blocks ids: n_valid probed blocks in
    ascending id (or shuffled; blocks 0 and 1, which hold the exact ties,
    among them), then garbage ids the kernel must never read."""
    rest = torch.randperm(n_blocks - 2, generator=g, device="cuda")[: max(n_valid - 2, 0)] + 2
    chosen = torch.cat([torch.arange(min(n_valid, 2), device="cuda"), rest])
    if order == "sorted":
        chosen = torch.sort(chosen)[0]
    else:
        chosen = chosen[torch.randperm(chosen.numel(), generator=g, device="cuda")]
    ids = torch.full((n_blocks,), IVF_GARBAGE, dtype=torch.int32, device="cuda")
    ids[:n_valid] = chosen.to(torch.int32)
    return ids, torch.tensor(n_valid, dtype=torch.int32, device="cuda")


def compare_ivf(tier: str, got, want, full_scores, what: str) -> float:
    """compare_live / compare_exact on the live slots, and every other slot
    NEG_INF in both with the plain version's fill row (JAX's: the best live
    row before the last probed block with one, or 0)."""
    from youtu_rag_tpu_torch.ops.topk import NEG_INF

    (s, i), (ws, wi) = ((t.cpu() for t in res) for res in (got, want))
    dead = ws <= NEG_INF / 2
    check(torch.equal(s <= NEG_INF / 2, dead), f"{what}: live slots differ")
    check(bool((s[dead] == NEG_INF).all() and (ws[dead] == NEG_INF).all()),
          f"{what}: an empty slot does not score NEG_INF")
    check(torch.equal(i[dead], wi[dead]), f"{what}: an empty slot's fill row differs")
    if tier != "bfloat16":
        return compare_exact(got, want, what)
    err = compare_live(got, want, full_scores, what)
    # a tie of both in the plain version's order (its stable sort keeps probe order)
    for a in range(ws.shape[0]):
        n_live = int((~dead[a]).sum())
        rank = {int(r): (j, float(v)) for j, (r, v) in
                enumerate(zip(wi[a, :n_live].tolist(), ws[a, :n_live].tolist()))}
        for t in range(n_live - 1):
            r0, r1 = int(i[a, t]), int(i[a, t + 1])
            if s[a, t] == s[a, t + 1] and r0 in rank and r1 in rank \
                    and rank[r0][1] == rank[r1][1]:
                check(rank[r0][0] < rank[r1][0], f"{what}: tie not in probe order, query {a}")
    return err


def ivf_kernel_cases(seed: int) -> dict[str, float]:
    from youtu_rag_tpu_torch.ops.topk import NEG_INF

    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randn(IVF_N, IVF_D, generator=g, device="cuda")
    x /= x.norm(dim=1, keepdim=True)
    x[100:110] = x[5]  # exact ties, in blocks 0 and 1 at every block_rows
    bias = torch.zeros(IVF_N, device="cuda")
    bias[::7] = NEG_INF
    bias[3::11] = float("-inf")
    bias[104] = NEG_INF
    sparse = torch.full((IVF_N,), NEG_INF, device="cuda")
    sparse[torch.arange(3, IVF_N, IVF_N // 5, device="cuda")] = 0.0  # 5 live rows
    ties = [r for r in (5, *range(100, 110)) if bias[r] == 0]
    stored = {}  # tier → (stored rows, scales as extra arguments)
    for tier, (_, _, quantize) in ivf_ops().items():
        if quantize is None:
            stored[tier] = (x.to(torch.bfloat16), ())
        else:
            xq, xs = quantize(x)
            stored[tier] = (xq, (xs,))
    cases = [(q, k, br, IVF_N // br // 2, "mixed") for q, k, br in IVF_CASES]
    for br in (64, 1024, 4096):
        nb = IVF_N // br
        cases += [(8, 10, br, 0, "mixed"), (8, 10, br, 1, "mixed"), (8, 129, br, nb, "mixed"),
                  (8, 50, br, nb, "sparse"), (64, 1024, br, 2, "mixed")]
    max_err = dict.fromkeys(TIERS, 0.0)
    for q, k, br, n_valid, kind in cases:
        queries = torch.randn(q, IVF_D, generator=g, device="cuda")
        queries /= queries.norm(dim=1, keepdim=True)
        queries[0] = x[5]
        ids, nv = ivf_plan(IVF_N // br, n_valid, g)
        b = bias if kind == "mixed" else sparse
        full = plain_scores(queries, stored["bfloat16"][0], b).cpu()
        for tier, (kernel, plain, _) in ivf_ops().items():
            xt, extra = stored[tier]
            what = f"ivf {tier} q={q} k={k} block_rows={br} n_valid={n_valid} {kind}"
            got = kernel(queries, xt, *extra, b, ids, nv, k, block_rows=br)
            torch.cuda.synchronize()
            want = plain(queries, xt, *extra, b, ids, nv, k, block_rows=br)
            max_err[tier] = max(max_err[tier], compare_ivf(tier, got, want, full, what))
            if kind == "mixed" and n_valid >= 2 and tier != "bfloat16":
                top = got[1][0, : min(k, len(ties))].tolist()
                check(top == ties[: len(top)], f"{what}: tie order {top}")
            if n_valid == 0:
                check(bool((got[0] == NEG_INF).all()), f"{what}: an empty plan returned rows")
    kernel, plain, quantize = ivf_ops()["int4"]
    x4, s4 = quantize(x[:IVF4_N])
    b4 = bias[:IVF4_N]
    for q, k, br in IVF4_CASES:
        queries = torch.randn(q, IVF_D, generator=g, device="cuda")
        queries /= queries.norm(dim=1, keepdim=True)
        queries[0] = x[5]
        ids, nv = ivf_plan(IVF4_N // br, IVF4_N // br // 2, g)
        what = f"ivf int4 q={q} k={k} block_rows={br}"
        got = kernel(queries, x4, s4, b4, ids, nv, k, block_rows=br)
        torch.cuda.synchronize()
        want = plain(queries, x4, s4, b4, ids, nv, k, block_rows=br)
        compare_ivf("int4", got, want, None, what)
    for q, k, br, qdtype, order in IVF_TMA_CASES:
        queries = torch.randn(q, IVF_D, generator=g, device="cuda")
        queries /= queries.norm(dim=1, keepdim=True)
        queries[0] = x[5]
        if q > 1:
            queries[1] = 0.0
        if qdtype == "bf16":
            queries = queries.to(torch.bfloat16)
        n = IVF_N - IVF_N % br  # the rows that whole blocks cover
        ids, nv = ivf_plan(n // br, n // br // 2, g, order)
        b = bias[:n]
        full = plain_scores(queries, stored["bfloat16"][0][:n], b).cpu()
        for tier in TIERS:
            kernel, plain, _ = ivf_ops()[tier]
            xt, extra = stored[tier]
            xt, extra = xt[:n], tuple(e[:n] for e in extra)
            what = f"ivf {tier} q={q} k={k} block_rows={br} {qdtype} queries, ids {order}"
            before = kernel.launches
            got = kernel(queries, xt, *extra, b, ids, nv, k, block_rows=br)
            torch.cuda.synchronize()
            check(kernel.launches - before == -(-q // 64), f"{what}: launches")
            want = plain(queries, xt, *extra, b, ids, nv, k, block_rows=br)
            max_err[tier] = max(max_err[tier], compare_ivf(tier, got, want, full, what))
    print(f"IVF kernel vs plain: {len(cases)} cases x {len(TIERS)} kernels, {len(IVF4_CASES)} "
          f"int4 cases (block_rows 4, 8, 12) and {len(IVF_TMA_CASES)} cases x 3 kernels "
          "(ivf_scan_tma.cuh: q 1-65, k to 1025, block_rows 4, 12, 4096, bf16 queries, a zero "
          "query, shuffled ids) ok, max_abs_err "
          + ", ".join(f"{IVF_NAMES[t]} {e}" for t, e in max_err.items()))
    return max_err


# ---------------------------------------------------------------------------
# 3f. kernel vs plain, IVF: any block_rows and alignment, wide rows
# ---------------------------------------------------------------------------

# block_rows off 4-row boundaries (JAX asks only that they divide the rows),
# each with k = 1, 10 (at most block_rows) and block_rows
REPAIR_BLOCK_ROWS = (1, 2, 6, 66, 1026)
# (d, k): where the lists or the query tile outgrow shared memory
WIDE_CASES = ((4096, 1024), (8192, 1024), (8192, 4096), (4096, 10))


def _offset(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` that starts 4 bytes past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    out.copy_(t)
    return out


def ivf_repair_cases(seed: int) -> dict[str, float]:
    """3f: (i) the three DMA entries at block_rows 1, 2, 6, 66 and 1026 with
    bias and scales 4 bytes past a 16-byte boundary, k up to block_rows;
    (ii) the three DMA entries and the bf16 and int8 merged per-block
    entries at d 4096 and 8192, k up to 4096 (device lists; bf16 at d =
    8192 the wide plan). Each
    against its plain version: rows equal, bf16 within TOL, int8/int4
    bit-equal. Returns the max abs error per kernel name."""
    from youtu_rag_tpu_torch.ops.topk import NEG_INF

    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    err: dict[str, float] = {}
    n_cases = 0
    d = IVF_D
    for br in REPAIR_BLOCK_ROWS:
        n = br * max(8, 8208 // br)
        x = torch.randn(n, d, generator=g, device="cuda")
        x /= x.norm(dim=1, keepdim=True)
        bias = torch.zeros(n, device="cuda")
        bias[::7] = NEG_INF
        bias[3::11] = float("-inf")
        bias = _offset(bias)
        ids, nv = ivf_plan(n // br, n // br // 2, g, "shuffled")
        queries = torch.randn(9, d, generator=g, device="cuda")
        queries /= queries.norm(dim=1, keepdim=True)
        full = plain_scores(queries, x.to(torch.bfloat16), bias).cpu()
        for tier, (kernel, plain, quantize) in ivf_ops().items():
            if quantize is None:
                xt, extra = x.to(torch.bfloat16), ()
            else:
                xt, xs = quantize(x)
                extra = (_offset(xs),)
            check(bias.data_ptr() % 16 == 4 and all(e.data_ptr() % 16 == 4 for e in extra),
                  "3f: the bias and scales must start 4 bytes past a 16-byte boundary")
            for k in sorted({1, min(10, br), br}):
                what = f"ivf {tier} block_rows={br} k={k}, bias and scales at +4 bytes"
                got = kernel(queries, xt, *extra, bias, ids, nv, k, block_rows=br)
                torch.cuda.synchronize()
                want = plain(queries, xt, *extra, bias, ids, nv, k, block_rows=br)
                name = IVF_NAMES[tier]
                err[name] = max(err.get(name, 0.0), compare_ivf(tier, got, want, full, what))
                n_cases += 1
    blocks = blocks_ops()
    for wd, k in WIDE_CASES:
        n, br = 3 * 4096, 4096
        x = torch.randn(n, wd, generator=g, device="cuda")
        x /= x.norm(dim=1, keepdim=True)
        bias = torch.zeros(n, device="cuda")
        bias[::5] = NEG_INF
        queries = torch.randn(9, wd, generator=g, device="cuda")
        queries /= queries.norm(dim=1, keepdim=True)
        ids = torch.tensor([2, 0, 1], dtype=torch.int32, device="cuda")
        nv = torch.tensor(2, dtype=torch.int32, device="cuda")
        full = plain_scores(queries, x.to(torch.bfloat16), bias).cpu()
        for tier in TIERS:
            kernel, plain, quantize = ivf_ops()[tier]
            if quantize is None:
                xt, extra = x.to(torch.bfloat16), ()
            else:
                xq, xs = quantize(x)
                xt, extra = xq, (xs,)
            what = f"ivf {tier} d={wd} k={k}"
            got = kernel(queries, xt, *extra, bias, ids, nv, k, block_rows=br)
            torch.cuda.synchronize()
            want = plain(queries, xt, *extra, bias, ids, nv, k, block_rows=br)
            name = IVF_NAMES[tier]
            err[name] = max(err.get(name, 0.0), compare_ivf(tier, got, want, full, what))
            n_cases += 1
            if tier == "int4":  # no per-block int4 kernel (JAX has none)
                continue
            name = "ivf_topk" if tier == "bfloat16" else "ivf_topk_int8"
            kernel, plain = blocks[name][:2]
            got = kernel(queries, xt, *extra, bias, ids, nv, k, block_rows=br)
            torch.cuda.synchronize()
            want = plain(queries, xt, *extra, bias, ids, nv, k, block_rows=br)
            tier_b = "bf16" if tier == "bfloat16" else "int8"
            err[name] = max(err.get(name, 0.0),
                            compare_blocks(tier_b, got, want, full, f"{name} d={wd} k={k}"))
            n_cases += 1
        del x, full
    print(f"IVF any block_rows and alignment, wide rows: {n_cases} cases ok (block_rows "
          f"{REPAIR_BLOCK_ROWS} at +4-byte bias and scales; (d, k) {WIDE_CASES}), max_abs_err "
          + ", ".join(f"{n} {e}" for n, e in err.items()))
    return err


# ---------------------------------------------------------------------------
# 3d. kernel vs plain, per-block
# ---------------------------------------------------------------------------

BLOCKS_N, BLOCKS_D = 65536, 256
BLOCK_TIES = (5, 5000, 20000, 40000)  # copies of row 5, in four blocks at every block_rows
# (q, k, block_rows, bias kind, plan): plan None (brute) or (n_valid, id order);
# n_valid "only" is a plan of one listed block
BLOCKS_CASES = (
    [(q, k, 1024, "mixed", None) for q in (1, 8, 64) for k in (1, 10, 128, 129, 1024)]
    + [(8, k, br, "mixed", None) for br in (256, 2048, 4096) for k in (10, 129)]
    + [(8, k, 1024, kind, None) for kind in ("sparse", "allinf0", "none") for k in (10, 128)]
    + [(8, 10, br, "mixed", (nv, order)) for br in (256, 1024, 4096)
       for nv in ("0", "1", "half", "max") for order in ("ascending", "shuffled")]
    + [(q, k, 1024, "mixed", ("half", "shuffled")) for q, k in ((1, 1), (64, 128), (8, 129),
                                                               (8, 1024))]
    + [(8, k, 1024, kind, ("half", "shuffled")) for kind in ("sparse", "allinf0", "none")
       for k in (10, 128)]
    # block_rows 4, 6 and 12 (a 32-row stage spans several blocks; at 6 runs
    # start off 4-row boundaries, so the merged kernel copies bias and scales
    # element by element) and k = block_rows
    + [(8, k, br, kind, plan) for br in (4, 6, 12) for k in (1, br)
       for kind in ("mixed", "deadcols") for plan in (("half", "shuffled"), ("max", "ascending"))]
    + [(8, 256, 256, kind, ("half", "shuffled")) for kind in ("mixed", "deadcols")]
    # no live row, position 0 (block 0) scoring -inf throughout: the tail's
    # last slot comes from position 1 (k a multiple of 128), from the pad
    # (k = 10) or is position 0's -inf entry (one listed block)
    + [(8, k, br, "allinf0dead", (nv, "ascending"))
       for k, br, nv in ((128, 256, "max"), (128, 4096, "max"), (1024, 1024, "1"),
                         (10, 256, "half"), (128, 256, "only"))]
)


def compare_blocks(tier: str, got, want, full, what: str) -> float:
    """Per-block results, candidates [blocks, q, k_pad] or merged [q, k]:
    the same live slots; every other slot (the fill and the pad) the same
    row and the same score bits; int8 live slots the same rows and score
    bits; bf16 live slots scores within TOL and the same rows, except that
    a slot may hold another row whose plain score (``full`` [q, N]) is
    within TOL of the plain version's there (two rows that close may swap
    when the sums run in another order). Returns the max abs score error."""
    from youtu_rag_tpu_torch.ops.topk import NEG_INF

    gs, gi = (t.cpu() for t in got)
    ws, wi = (t.cpu() for t in want)
    check(gs.shape == ws.shape and gi.shape == wi.shape, f"{what}: shapes {gs.shape} {ws.shape}")
    live = ws > NEG_INF / 2
    check(torch.equal(gs > NEG_INF / 2, live), f"{what}: live slots differ")
    check(torch.equal(gi[~live], wi[~live]), f"{what}: a fill or pad slot holds another row")
    check(torch.equal(gs[~live].view(torch.int32), ws[~live].view(torch.int32)),
          f"{what}: a fill or pad slot holds another score")
    if tier == "int8":
        check(torch.equal(gi, wi), f"{what}: rows differ")
        check(torch.equal(gs.view(torch.int32), ws.view(torch.int32)), f"{what}: scores not bit-equal")
        return 0.0
    if not bool(live.any()):
        return 0.0
    err = float((gs[live] - ws[live]).abs().max())
    check(err <= TOL, f"{what}: score error {err} > {TOL}")
    swapped = live & (gi != wi)
    if bool(swapped.any()):
        qidx = torch.arange(gi.shape[-2])[:, None].expand(gi.shape[-2:]).expand(gi.shape)
        alt = full[qidx[swapped], gi[swapped].long()]
        gap = float((alt - ws[swapped]).abs().max())
        check(gap <= TOL, f"{what}: {int(swapped.sum())} rows differ beyond near-ties ({gap})")
    return err


def blocks_plan(nb: int, nv_kind: str, order: str, g) -> tuple[torch.Tensor, torch.Tensor, int]:
    """A plan over nb blocks: max_blocks = 3/4 of them (at least 1), every
    id in range as the probe plan lists them, block 0 (a block scoring -inf
    throughout in the allinf0 bias) among the first n_valid; those first
    n_valid ascending or shuffled. Returns (ids, n_valid tensor, n_valid)."""
    mb = 1 if nv_kind == "only" else max(1, 3 * nb // 4)
    nv = {"0": 0, "1": 1, "half": mb // 2, "max": mb, "only": 1}[nv_kind]
    perm = torch.cat([torch.zeros(1, dtype=torch.long, device="cuda"),
                      torch.randperm(nb - 1, generator=g, device="cuda") + 1])[:mb]
    head = perm[:nv]
    head = torch.sort(head)[0] if order == "ascending" else head[
        torch.randperm(nv, generator=g, device="cuda")]
    ids = torch.cat([head, perm[nv:]]).to(torch.int32)
    return ids, torch.tensor(nv, dtype=torch.int32, device="cuda"), nv


def blocks_kernel_cases(seed: int) -> dict[str, float]:
    from youtu_rag_tpu_torch.ops.topk import NEG_INF, fused_topk, merge_blocks, quantize_rows_int8

    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    n = BLOCKS_N
    x = torch.randn(n, BLOCKS_D, generator=g, device="cuda")
    x /= x.norm(dim=1, keepdim=True)
    x[list(BLOCK_TIES[1:])] = x[BLOCK_TIES[0]].clone()
    mixed = torch.zeros(n, device="cuda")
    mixed[::7] = NEG_INF
    mixed[3::11] = float("-inf")
    sparse = torch.full((n,), NEG_INF, device="cuda")
    sparse[:3] = float("-inf")
    sparse[torch.arange(3, n, n // 5, device="cuda")] = 0.0  # 5 live rows
    allinf0 = mixed.clone()
    allinf0[:4096] = float("-inf")  # block 0 at every block_rows scores -inf throughout
    # no live row: NEG_INF, except rows 0-4095 -inf and columns 0-2 of every
    # 4096-row block past them (block 1's lowest column scoring NEG_INF is 3)
    allinf0dead = torch.full((n,), NEG_INF, device="cuda")
    allinf0dead[torch.arange(n, device="cuda") % 4096 < 3] = float("-inf")
    allinf0dead[:4096] = float("-inf")
    # five live rows; rows r % 256 < 3 -inf, the rest NEG_INF (the fill of a
    # block whose first columns score -inf is its column 3, or 0 at block_rows 4)
    deadcols = torch.full((n,), NEG_INF, device="cuda")
    deadcols[torch.arange(n, device="cuda") % 256 < 3] = float("-inf")
    deadcols[torch.arange(100, n, n // 5, device="cuda")] = 0.0
    biases = {"mixed": mixed, "sparse": sparse, "allinf0": allinf0, "allinf0dead": allinf0dead,
              "deadcols": deadcols, "none": torch.full((n,), NEG_INF, device="cuda")}
    xq, xs = quantize_rows_int8(x)
    stored = {"bfloat16": (x.to(torch.bfloat16), ()), "int8": (xq, (xs,))}
    max_err = dict.fromkeys(BLOCKS_NAMES, 0.0)
    n_checked = 0
    # the brute kernels take every case's (q, k, block_rows, bias) once, the
    # plan dropped: block_rows 4-4096, k = block_rows, every tail
    brute_seen = set()
    added_s = 0.0  # seconds of the brute checks on the planned cases' shapes
    for q, k, br, kind, plan_kind in BLOCKS_CASES:
        nr = n - n % br  # the rows whole blocks cover
        queries = torch.randn(q, BLOCKS_D, generator=g, device="cuda")
        queries /= queries.norm(dim=1, keepdim=True)
        queries[0] = x[BLOCK_TIES[0]]
        b = biases[kind][:nr]
        full = plain_scores(queries, stored["bfloat16"][0][:nr], b).cpu()
        plan, probe = (), None
        if plan_kind is not None:
            ids, nv, n_valid = blocks_plan(nr // br, *plan_kind, g)
            plan = (ids, nv)
            probe = ids[:n_valid].tolist()
        brute_new = (q, k, br, kind) not in brute_seen
        brute_seen.add((q, k, br, kind))
        for name, (kernel, plain, tier, ivf) in blocks_ops().items():
            if ivf != (plan_kind is not None) and (ivf or not brute_new):
                continue
            t0 = time.perf_counter()
            xt, extra = stored[tier]
            xt, extra = xt[:nr], tuple(e[:nr] for e in extra)
            args = (queries, xt, *extra, b, *(plan if ivf else ()), k)
            what = (f"{name} q={q} k={k} block_rows={br} {kind}"
                    + (f" plan={plan_kind}" if ivf else ""))
            want = plain(*args, block_rows=br, candidates=True)
            err = 0.0
            if ivf or plan_kind is None:  # (the brute candidates at block_rows >= 256)
                got = kernel(*args, block_rows=br, candidates=True)
                torch.cuda.synchronize()
                err = compare_blocks(tier, got, want, full, what + " candidates")
            # the merged call: csrc/ivf_scan_tma.cuh's per-block entry (brute:
            # the identity plan), one launch per 64 queries, the merge inside
            before = kernel.launches
            merged = kernel(*args, block_rows=br)
            torch.cuda.synchronize()
            check(kernel.launches - before == -(-q // 64), f"{what}: merged call's launches")
            ref = (fused_topk(queries, xt, b, k, block_rows=br, backend="pallas_interpret")
                   if name == "topk" and plan_kind is None else merge_blocks(*want, k))
            err = max(err, compare_blocks(tier, merged, ref, full, what))
            if kind == "mixed" and k >= len(BLOCK_TIES):
                # exact ties in position order: block (row) order, or probe order
                live = [r for r in BLOCK_TIES if b[r] == 0]
                ties = (live if not ivf else
                        [r for p in probe for r in live if r // br == p])
                top = merged[1][0, : len(ties)].tolist()
                check(top == ties, f"{what}: tie order {top}, expected {ties}")
            max_err[name] = max(max_err[name], err)
            n_checked += 1
            if not ivf and plan_kind is not None:
                added_s += time.perf_counter() - t0
    torch.cuda.synchronize()
    print(f"per-block kernel vs plain: {len(BLOCKS_CASES)} cases, {n_checked} kernel checks ok "
          f"(candidates, and merged through the merged kernels, brute over {len(brute_seen)} "
          "cases: block_rows 4-4096, k to 1024 and k = block_rows, tails past position 0; "
          f"those of the planned cases' shapes {added_s:.2f} s), max_abs_err "
          + ", ".join(f"{name} {e}" for name, e in max_err.items()))
    return max_err


# ---------------------------------------------------------------------------
# 3 (continued). any query count, k above 1024
# ---------------------------------------------------------------------------

QUERY_COUNTS = (0, 65, 100, 130)  # around and past the 64 queries of one launch
BIG_K = {"bfloat16": (2048, 4096), "int8": (8192,), "int4": (2048, 4096)}


def all_topk_wrappers() -> dict:
    """Every top-k wrapper: name → (wrapper, plain version, tier, kind);
    kind "brute", "ivf" (a plan, merged) or "blocks"/"ivf_blocks"."""
    out = {KERNEL_NAMES[t]: (w, p, t, "brute") for t, (w, p, _) in ops().items()}
    out.update({IVF_NAMES[t]: (w, p, t, "ivf") for t, (w, p, _) in ivf_ops().items()})
    out.update({name: (w, p, tier, "ivf_blocks" if plan else "blocks")
                for name, (w, p, tier, plan) in blocks_ops().items()})
    return out


def wrapper_args(tier: str, kind: str, stored: dict, bias, plan):
    """The arguments after the queries and before k, and the keywords."""
    x, extra = stored[tier]
    kw = {} if kind == "brute" else {"block_rows": plan[2]}
    return (x, *extra, bias, *(plan[:2] if kind in ("ivf", "ivf_blocks") else ())), kw


def compare_tier(tier: str, got, want, full, what: str) -> float:
    if tier == "bfloat16":
        return compare_topk(got, want, full, what)
    return compare_exact(got, want, what)


def query_k_cases(seed: int) -> dict[str, float]:
    """q = 0 (no launch, an empty result), 65, 100 and 130 (one launch per
    64 queries) through every top-k wrapper; k = 2048 / 4096 (bf16, int4)
    and 8192 (int8) through the pruned kernels, and k = 2048 through one
    IVF and one per-block case (the device-memory list class). Each held to
    its plain version on the same tensors."""
    from youtu_rag_tpu_torch.ops.topk import NEG_INF, quantize_rows_int4, quantize_rows_int8

    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    n, d = 65536, 256
    x = torch.randn(n, d, generator=g, device="cuda")
    x /= x.norm(dim=1, keepdim=True)
    bias = torch.zeros(n, device="cuda")
    bias[::7] = NEG_INF
    bias[3::11] = float("-inf")
    stored = {"bfloat16": (x.to(torch.bfloat16), ()), "int8": (lambda t: (t[0], (t[1],)))(
        quantize_rows_int8(x)), "int4": (lambda t: (t[0], (t[1],)))(quantize_rows_int4(x))}
    ids, nv = ivf_plan(n // 1024, n // 1024 // 2, g)
    plan = (ids, nv, 1024)
    max_err = {}
    wrappers = all_topk_wrappers()
    n_checked = 0
    for qn in QUERY_COUNTS:
        queries = torch.randn(qn, d, generator=g, device="cuda")
        queries /= queries.norm(dim=1, keepdim=True).clamp_min(1e-12)
        full = plain_scores(queries, stored["bfloat16"][0], bias).cpu()
        for name, (wrapper, plain, tier, kind) in wrappers.items():
            args, kw = wrapper_args(tier, kind, stored, bias, plan)
            what = f"{name} q={qn}"
            before = wrapper.launches
            got = wrapper(queries, *args, 10, **kw)
            torch.cuda.synchronize()
            launched = wrapper.launches - before
            check(launched == -(-qn // 64), f"{what}: {launched} launches, want {-(-qn // 64)}")
            want = plain(queries, *args, 10, **kw)
            check(tuple(got[0].shape) == tuple(want[0].shape) == (qn, 10),
                  f"{what}: shapes {tuple(got[0].shape)} {tuple(want[0].shape)}")
            if kind in ("blocks", "ivf_blocks"):
                err = compare_blocks(tier, got, want, full, what)
                cand = wrapper(queries, *args, 10, candidates=True, **kw)
                cand_want = plain(queries, *args, 10, candidates=True, **kw)
                check(cand[0].shape[1] == qn, f"{what}: candidates {tuple(cand[0].shape)}")
                err = max(err, compare_blocks(tier, cand, cand_want, full, what + " candidates"))
            else:
                err = compare_tier(tier, got, want, full, what) if qn else 0.0
            max_err[name] = max(max_err.get(name, 0.0), err)
            n_checked += 1
    big = [(tier, k, qn) for tier, ks in BIG_K.items() for k in ks for qn in (8, 65)]
    for tier, k, qn in big:
        queries = torch.randn(qn, d, generator=g, device="cuda")
        queries /= queries.norm(dim=1, keepdim=True)
        full = plain_scores(queries, stored["bfloat16"][0], bias).cpu()
        name = KERNEL_NAMES[tier]
        wrapper, plain, _, _ = wrappers[name]
        args, _ = wrapper_args(tier, "brute", stored, bias, plan)
        got = wrapper(queries, *args, k)
        torch.cuda.synchronize()
        err = compare_tier(tier, got, plain(queries, *args, k), full, f"{name} q={qn} k={k}")
        max_err[name] = max(max_err[name], err)
        n_checked += 1
    queries = torch.randn(8, d, generator=g, device="cuda")
    queries /= queries.norm(dim=1, keepdim=True)
    full = plain_scores(queries, stored["bfloat16"][0], bias).cpu()
    # the per-block wrappers: the candidates (csrc/topk_blocks.cu) and the
    # merged calls (csrc/ivf_scan_tma.cuh) in the shared and device list
    # classes, k = block_rows included
    big_blocks = [("ivf_topk_dma", 2048, 1024, False), ("topk", 2048, 4096, True),
                  ("ivf_topk_int8", 2048, 4096, True), ("ivf_topk_int8", 2048, 4096, False),
                  ("ivf_topk", 1024, 4096, False), ("ivf_topk", 4096, 4096, False),
                  ("topk", 4096, 4096, False), ("topk_int8", 2048, 4096, False)]
    for name, k, br, cand in big_blocks:
        wrapper, plain, tier, kind = wrappers[name]
        kplan = plan if br == 1024 else (*ivf_plan(n // br, n // br // 2, g), br)
        args, kw = wrapper_args(tier, kind, stored, bias, kplan)
        if "blocks" in kind:
            kw["candidates"] = cand
        what = f"{name} q=8 k={k} block_rows={br}" + (" candidates" if cand else "")
        got = wrapper(queries, *args, k, **kw)
        torch.cuda.synchronize()
        want = plain(queries, *args, k, **kw)
        err = (compare_blocks(tier, got, want, full, what) if "blocks" in kind
               else compare_ivf(tier, got, want, full, what))
        max_err[name] = max(max_err[name], err)
        n_checked += 1
    print(f"any q and k above 1024: {n_checked} checks ok (q {QUERY_COUNTS} through "
          f"{len(wrappers)} wrappers, the per-block ones merged by their kernel and as "
          f"candidates; k {BIG_K} brute; k 2048 IVF, per-block k 1024-4096), max_abs_err "
          + ", ".join(f"{n} {e}" for n, e in max_err.items()))
    return max_err


# ---------------------------------------------------------------------------
# 3e. kernel vs plain, the ring hop
# ---------------------------------------------------------------------------

# (T, T_kv, bias kind, hd, dtype, layout, B, H): "mixed" pads row 0's keys
# past T_kv / 2 + 3 and masks the last row throughout; "allpad" masks every
# key of the span (the encoder's -1e9: m is about -1e9, not -1e30); T_kv =
# 128 is one key tile (the Hopper kernel's peeled tile is also its last);
# "strided" takes q, k, v as the encoder's [B, T, H, hd] views; [16, 12,
# 512, 64] gives 768 work items, several per CTA of the persistent grid
STATS_CASES = [(t, t_kv, kind, hd, dtype, "contiguous", 3, 2)
               for t, t_kv, kind in ((128, 128, "mixed"), (256, 256, "mixed"),
                                     (1024, 1024, "mixed"), (8192, 8192, "mixed"),
                                     (1024, 128, "mixed"), (1024, 512, "mixed"),
                                     (1024, 4096, "mixed"), (1024, 512, "allpad"),
                                     (1024, 128, "allpad"))
               for hd in (64, 128) for dtype in (torch.bfloat16, torch.float32)]
STATS_CASES += [(1024, t_kv, "mixed", hd, dtype, "strided", 3, 2) for t_kv in (1024, 512)
                for hd in (64, 128) for dtype in (torch.bfloat16, torch.float32)]
STATS_CASES += [(512, 512, "mixed", 64, torch.bfloat16, "contiguous", 16, 12)]


def compare_stats(got, want, what: str) -> float:
    """m within f32 summation order (1e-5 absolute plus 1e-6 relative), l
    and acc / l within the flash entry's tolerance (bf16 one bf16 ulp,
    rtol 2^-7 and 2^-10 absolute; f32 1e-5, l relative); no NaN. Returns
    the max abs error of acc / l."""
    (ga, gm, gl), (wa, wm, wl) = got, want
    for t in (ga, gm, gl):
        check(bool(torch.isfinite(t).all()), f"{what}: non-finite acc, m or l")
    check(ga.dtype == gm.dtype == gl.dtype == torch.float32, f"{what}: dtypes")
    check(ga.shape == wa.shape and gm.shape == wm.shape == gl.shape, f"{what}: shapes")
    dm = (gm - wm).abs()
    check(bool((dm <= 1e-5 + 1e-6 * wm.abs()).all()), f"{what}: m differs by {float(dm.max())}")
    rtol = 2**-7 if what.endswith("bfloat16") else 1e-5
    dl = (gl - wl).abs() / wl.abs()
    check(bool((dl <= rtol).all()), f"{what}: l differs by {float(dl.max())} relative")
    go, wo = ga / gl[..., None], wa / wl[..., None]
    atol = 2**-10 if rtol > 1e-5 else 1e-5
    bad = (go - wo).abs() > atol + rtol * wo.abs()
    err = float((go - wo).abs().max())
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} acc / l beyond tolerance, max {err}")
    return err


def stats_inputs(t: int, t_kv: int, kind: str, hd: int, dtype, g, layout: str = "contiguous",
                 b: int = 3, h: int = 2):
    if layout == "strided":  # [B, T, H, hd] seen as [B, H, T, hd], as the encoder passes them
        q = torch.randn(b, t, h, hd, generator=g, device="cuda").to(dtype).transpose(1, 2)
        k, v = (torch.randn(b, t_kv, h, hd, generator=g, device="cuda").to(dtype).transpose(1, 2)
                for _ in range(2))
    else:
        q = torch.randn(b, h, t, hd, generator=g, device="cuda").to(dtype)
        k, v = (torch.randn(b, h, t_kv, hd, generator=g, device="cuda").to(dtype)
                for _ in range(2))
    mask = torch.ones(b, t_kv, device="cuda")
    if kind == "mixed":
        mask[0, t_kv // 2 + 3 :] = 0
        mask[-1] = 0
    else:
        mask[:] = 0
    return q, k, v, (1.0 - mask) * -1e9


def combine_hops(hops, dtype):
    """The ring's combine of (acc, m, l) hops, then the divide."""
    acc, m, l = hops[0]
    for acc_h, m_h, l_h in hops[1:]:
        m_new = torch.maximum(m, m_h)
        a_old, a_hop = torch.exp(m - m_new), torch.exp(m_h - m_new)
        l = l * a_old + l_h * a_hop
        acc = acc * a_old[..., None] + acc_h * a_hop[..., None]
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(dtype)


def stats_cases(seed: int) -> float:
    from youtu_rag_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_stats,
        flash_attention_stats_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    max_err = 0.0
    for t, t_kv, kind, hd, dtype, layout, b, h in STATS_CASES:
        args = stats_inputs(t, t_kv, kind, hd, dtype, g, layout, b, h)
        got = flash_attention_stats(*args)
        torch.cuda.synchronize()
        what = (f"flash_attention_stats [{b}, {h}, {t}, {hd}] T_kv={t_kv} {kind} {layout} "
                f"{str(dtype)[6:]}")
        max_err = max(max_err, compare_stats(got, flash_attention_stats_reference(*args), what))
    # two half-span hops, combined, against the flash kernel on the whole span
    for hd in (64, 128):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, bias = attention_inputs(3, 2, 1024, hd, dtype, g)
            halves = [flash_attention_stats(q, k[:, :, s], v[:, :, s], bias[:, s])
                      for s in (slice(0, 512), slice(512, 1024))]
            got = combine_hops(halves, dtype)
            torch.cuda.synchronize()
            err = compare_attention(got, flash_attention(q, k, v, bias),
                                    f"two hops vs flash_attention hd={hd} {str(dtype)[6:]}")
            max_err = max(max_err, err)
    print(f"ring hop kernel vs plain: {len(STATS_CASES)} cases and 4 two-hop combines ok, "
          f"max_abs_err {max_err}")
    return max_err


# ---------------------------------------------------------------------------
# 4. main path, small corpus
# ---------------------------------------------------------------------------

TOPICS = {
    "tpu.md": "# TPU\nHBM bandwidth on v5e is ~820 GB/s.\n",
    "cooking.md": "# Cooking\nBoil pasta for ten minutes in salted water, then drain it.",
    "astronomy.md": "# Astronomy\nJupiter has the largest moons; Ganymede is bigger than Mercury.",
    "gardening.md": "# Gardening\nTomato seedlings want compost, full sun and deep watering.",
    "finance.md": "# Finance\nCompound interest grows savings when dividends are reinvested.",
    "music.md": "# Music\nA violin quartet tunes its strings to concert pitch A440.",
    "cycling.md": "# Cycling\nInflate road bike tyres to eighty psi before a long ride.",
    "chess.md": "# Chess\nCastling moves the king two squares toward a rook.",
    "geology.md": "# Geology\nBasalt forms when lava cools quickly at the surface.",
    "sleep.md": "# Sleep\nAdults need seven to nine hours of sleep each night.",
    "coffee.md": "# Coffee\nEspresso extraction takes about twenty-five seconds at nine bar.",
    "birds.md": "# Birds\nArctic terns migrate from pole to pole every year.",
    "python.md": "# Python\nA list comprehension builds a list from an iterable in one line.",
    "sailing.md": "# Sailing\nTacking turns the bow of the boat through the wind.",
    "tea.md": "# Tea\nGreen tea steeps best in water below boiling, around eighty degrees.",
    "volcano.md": "# Volcanoes\nMount Etna in Sicily is among the most active volcanoes.",
    "running.md": "# Running\nMarathon runners taper their mileage before race day.",
    "bread.md": "# Bread\nSourdough rises with a starter of wild yeast and lactobacilli.",
    "glacier.md": "# Glaciers\nGlaciers carve U-shaped valleys as the ice slowly flows.",
    "photo.md": "# Photography\nA wide aperture gives a shallow depth of field.",
}
FILLER = (
    "notes archive record paragraph section appendix summary outline draft "
    "version revision index table figure caption footnote chapter volume"
).split()
QUERIES = [
    ("what bandwidth does v5e HBM have?", "tpu.md"),
    ("how long should pasta boil in salted water", "cooking.md"),
    ("which planet has moons bigger than Mercury", "astronomy.md"),
    ("what pressure for road bike tyres", "cycling.md"),
]
HYBRID_QUERY = ("tomato seedlings compost sun", "gardening.md")
HYBRID_INT4_K = 256  # pow2(4 x the fusion pool of 50): the int4 hybrid query's kernel k


def write_corpus(root: str, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for name, text in TOPICS.items():
        body = text
        if name != "tpu.md":  # the CLI demo file stays as it is
            for _ in range(7):  # ~15 chunks per file: > 256 live rows for the int4 pool
                words = rng.choice(FILLER, size=160)
                body += "\n\n" + " ".join(words) + "."
        with open(os.path.join(root, name), "w") as f:
            f.write(body)


async def _drive_kb(kb, files):
    status = await kb.build_files(files)
    return status, await _answers(kb)


async def _answers(kb):
    dense = [await kb.retriever.retrieve(q, top_k=5, similarity_threshold=0.0) for q, _ in QUERIES]
    hybrid = await kb.hybrid_retriever.retrieve(HYBRID_QUERY[0], top_k=5, similarity_threshold=0.0)
    return dense + [hybrid]


def tier_config(name: str, tier: str):
    from youtu_rag_tpu_torch.core.config import IndexConfig, RAGConfig, VectorStoreConfig

    return RAGConfig(name=name, vector_store=VectorStoreConfig(index=IndexConfig(storage_dtype=tier)))


def check_answers(tier: str, got, ref, what: str) -> float:
    """The intended top documents, finite scores, and the same ranking as
    ``ref`` (bf16: scores within TOL; int8/int4: equal scores). Returns the
    max abs score difference."""
    err = 0.0
    for (query, want), hits, ref_hits in zip(QUERIES + [HYBRID_QUERY], got, ref):
        check(len(hits) > 0, f"{what} {tier}: no hits for {query!r}")
        top = hits[0].chunk.document_id
        check(top == want, f"{what} {tier}: {query!r} top hit {top}, expected {want}")
        check(all(np.isfinite(r.score) for r in hits), f"{what} {tier}: {query!r} non-finite score")
        check([r.chunk.id for r in hits] == [r.chunk.id for r in ref_hits],
              f"{what} {tier}: {query!r} ranks different chunks")
        err = max(err, max(abs(a.score - b.score) for a, b in zip(hits, ref_hits)))
    check(err <= (TOL if tier == "bfloat16" else 0.0), f"{what} {tier}: scores differ by {err}")
    return err


def small_corpus(seed: int) -> tuple[dict[str, int], dict[str, float]]:
    import youtu_rag_tpu_torch.index.device_index as device_index
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase

    kernels = ops()
    asked: list[int] = []
    real_int4 = device_index.topk_int4_pruned

    def int4_spy(queries, x, scales, bias, k):  # records the k the index asks for
        asked.append(k)
        return real_int4(queries, x, scales, bias, k)

    launches, errs, kbs = {}, {}, {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        write_corpus(root, seed)
        files = sorted(os.path.join(f"{root}", f) for f in os.listdir(root))
        for tier in TIERS:
            kb = KnowledgeBase(f"smoke-{tier}", tier_config("smoke", tier), device="cuda")
            device_index.topk_int4_pruned = int4_spy
            try:
                reset_launches()
                status, got = asyncio.run(_drive_kb(kb, files))
                torch.cuda.synchronize()
                counts = launch_counts()
            finally:
                device_index.topk_int4_pruned = real_int4
            launches[tier] = counts[tier]
            print(f"small corpus {tier}: {len(files)} files, {status.total_chunks} chunks, "
                  f"launches {counts}")
            check(status.status == "completed" and not status.errors, f"build failed: {status.errors}")
            check(status.total_chunks >= HYBRID_INT4_K, f"only {status.total_chunks} chunks")
            check(counts[tier] > 0, f"the {tier} KB's searches never launched {KERNEL_NAMES[tier]}")
            check(all(n == 0 for t, n in counts.items() if t != tier),
                  f"the {tier} KB launched another tier's kernel: {counts}")
            cpu_kb = KnowledgeBase(f"smoke-{tier}-cpu", tier_config("smoke", tier), device="cpu")
            _, ref = asyncio.run(_drive_kb(cpu_kb, files))
            for (query, _), hits in zip(QUERIES + [HYBRID_QUERY], got):
                print(f"  {query!r} -> {hits[0].chunk.document_id} ({hits[0].score:.4f})")
            errs[tier] = check_answers(tier, got, ref, "CUDA vs CPU KB")
            kbs[tier] = kb
        print(f"int4 kernel k asked on the small KB: {sorted(set(asked))}")
        check(HYBRID_INT4_K in asked, f"the int4 hybrid query never asked its kernel for k = {HYBRID_INT4_K}")

        # the int4 KB through a snapshot, into a fresh CUDA KB
        snap = os.path.join(root, "snapshot")
        saved = kbs["int4"].save(snap)
        fresh = KnowledgeBase("smoke-int4-loaded", tier_config("smoke", "int4"), device="cuda")
        reset_launches()
        loaded = fresh.load(snap)
        got = asyncio.run(_answers(fresh))
        torch.cuda.synchronize()
        counts = launch_counts()
        launches["int4"] += counts["int4"]
        check(loaded["chunks"] == saved["chunks"] and counts["int4"] > 0,
              f"int4 snapshot: {saved} -> {loaded}, launches {counts}")
        twin = KnowledgeBase("smoke-int4-twin", tier_config("smoke", "int4"), device="cpu")
        twin.load(snap)
        check_answers("int4", got, asyncio.run(_answers(twin)), "int4 snapshot CUDA vs CPU")
        original = asyncio.run(_answers(kbs["int4"]))
        check([h[0].chunk.id for h in got] == [h[0].chunk.id for h in original],
              "the reloaded int4 KB's top chunks differ from the saved KB's")
        print(f"int4 KB saved and loaded into a fresh CUDA KB: {loaded['chunks']} chunks, "
              f"same answers, {counts['int4']} launches")

    # each kernel at the shapes this path gave it: q bucket 1 and 4, k 5 and 50
    for tier, kb in kbs.items():
        kernel, plain, quantize = kernels[tier]
        index = kb.store.index
        emb = kb.embedder.embed_batch([q for q, _ in QUERIES])
        extra = () if quantize is None else (index._scales,)
        x, b = index._vectors, index._bias
        for qn in (1, len(QUERIES)):
            q = torch.from_numpy(emb[:qn]).cuda()
            for k in (5, 50) + ((HYBRID_INT4_K,) if tier == "int4" else ()):
                got = kernel(q, x, *extra, b, k)
                torch.cuda.synchronize()
                want = plain(q, x, *extra, b, k)
                what = f"kb {tier} q={qn} k={k}"
                e = (compare_topk(got, want, plain_scores(q, x, b).cpu(), what)
                     if quantize is None else compare_exact(got, want, what))
                errs[tier] = max(errs[tier], e)
    return launches, errs


# ---------------------------------------------------------------------------
# 4c. main path, small corpus, IVF
# ---------------------------------------------------------------------------


class Recorder:
    """Stands in for an IVF wrapper in the index module and keeps the
    inputs of each call (the kernel still counts its launches)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return self.fn(*args, **kw)


def ivf_config(name: str, tier: str):
    from youtu_rag_tpu_torch.core.config import IndexConfig, RAGConfig, VectorStoreConfig

    return RAGConfig(name=name, vector_store=VectorStoreConfig(
        index=IndexConfig(storage_dtype=tier, block_rows=64)))


def top_documents(answers) -> list[str]:
    return [hits[0].chunk.document_id for hits in answers]


def small_corpus_ivf(seed: int) -> tuple[dict[str, int], dict[str, float]]:
    import youtu_rag_tpu_torch.index.device_index as device_index
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase

    launches, errs = {}, dict.fromkeys(TIERS, 0.0)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        write_corpus(root, seed)
        files = sorted(os.path.join(root, f) for f in os.listdir(root))
        for tier in TIERS:
            kernel, plain, _ = ivf_ops()[tier]
            kb = KnowledgeBase(f"ivf-{tier}", ivf_config("ivf", tier), device="cuda")
            cpu_kb = KnowledgeBase(f"ivf-{tier}-cpu", ivf_config("ivf", tier), device="cpu")
            asyncio.run(kb.build_files(files))
            asyncio.run(cpu_kb.build_files(files))
            for k_b in (kb, cpu_kb):
                k_b.store._index.build_ivf()
            spy = Recorder(getattr(device_index, IVF_NAMES[tier]))
            setattr(device_index, IVF_NAMES[tier], spy)
            try:
                reset_launches()
                got = asyncio.run(_answers(kb))
                torch.cuda.synchronize()
                counts, brute = ivf_counts(), launch_counts()
            finally:
                setattr(device_index, IVF_NAMES[tier], spy.fn)
            ref = asyncio.run(_answers(cpu_kb))
            st = kb.store._index._ivf
            print(f"IVF KB {tier}: {kb.store._index.count()} chunks, {st.n_lists} lists, "
                  f"n_probe {st.n_probe}; IVF launches {counts}, brute {brute}")
            for (query, want), hits in zip(QUERIES + [HYBRID_QUERY], got):
                check(bool(hits) and hits[0].chunk.document_id == want,
                      f"IVF KB {tier}: {query!r} top hit {hits and hits[0].chunk.document_id}")
                check(all(np.isfinite(r.score) for r in hits), f"IVF KB {tier}: non-finite score")
            check(top_documents(got) == top_documents(ref),
                  f"IVF KB {tier}: top documents differ from the CPU twin's")
            check(counts[tier] > 0 and sum(counts.values()) == counts[tier],
                  f"IVF KB {tier}: IVF launches {counts}")
            check(sum(brute.values()) == 0, f"IVF KB {tier}: brute launches {brute} (no tuner)")
            launches[tier] = counts[tier]
            # each IVF call of the path, against the plain version
            for args, kw in spy.calls:
                want = plain(*args, **kw)
                res = kernel(*args, **kw)
                torch.cuda.synchronize()
                # (queries, x, bias, ...) for bf16; compare_exact needs no scores
                full = plain_scores(*args[:3]).cpu() if tier == "bfloat16" else None
                errs[tier] = max(errs[tier], compare_ivf(tier, res, want, full,
                                                         f"IVF KB {tier} call k={args[-1]}"))
            print(f"  {len(spy.calls)} IVF calls of the path match the plain version; "
                  f"top documents {top_documents(got)} as the CPU twin's")
            # through a snapshot into a fresh CUDA KB, which builds IVF again
            snap = os.path.join(root, f"snap-{tier}")
            kb.save(snap)
            fresh = KnowledgeBase(f"ivf-{tier}-loaded", ivf_config("ivf", tier), device="cuda")
            reset_launches()
            fresh.load(snap)
            again = asyncio.run(_answers(fresh))
            torch.cuda.synchronize()
            n = ivf_counts()[tier]
            launches[tier] += n
            check(fresh.store._index._ivf is not None and n > 0,
                  f"IVF KB {tier}: the reloaded KB has no IVF or never launched it ({n})")
            check(top_documents(again) == top_documents(got),
                  f"IVF KB {tier}: the reloaded KB's top documents differ")
            print(f"  saved and loaded into a fresh CUDA KB: IVF rebuilt "
                  f"({fresh.store._index._ivf.n_lists} lists), same top documents, {n} launches")
    return launches, errs


# ---------------------------------------------------------------------------
# 4b. main path, small corpus, encoder
# ---------------------------------------------------------------------------

WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "benchmarks", "models", "yrt_tiny_lex")
ENC_TOL = 3e-2  # the JAX package's bf16 encoder tolerance (tests/ops/test_attention.py:41)
IDENTIFIER_DOCS = {  # tests/models/test_weights_dir.py:34-45, in its ranking order
    "kl4407.md": "Maintenance log for unit KL-4407. The inventory tag recorded for "
                 "unit KL-4407 is 88213.",
    "qx9911.md": "Maintenance log for unit QX-9911. The inventory tag recorded for "
                 "unit QX-9911 is 55120.",
    "glacier_survey.md": "An unrelated paragraph about glacier hydrology field surveys.",
}
IDENTIFIER_QUERY = "What is the inventory tag recorded for KL-4407?"


def encoder_config(name: str, weights_dir: str | None = None):
    from youtu_rag_tpu_torch.core.config import EmbeddingConfig, RAGConfig

    cfg = RAGConfig(name=name)
    cfg.knowledge_builder.embedding = EmbeddingConfig(provider="tpu", weights_dir=weights_dir)
    return cfg


def serve_with(kb, embedder) -> None:
    """Put ``embedder`` in every part of ``kb`` that embeds (a CPU twin
    that runs the kernels' plain versions; a re-serve with "pallas")."""
    for part in (kb, kb.retriever, kb.hybrid_retriever, kb.builder):
        part.embedder = embedder


def stored_vectors(kb) -> dict[str, np.ndarray]:
    index = kb.store.index
    return {cid: index._vectors[row].float().cpu().numpy() for cid, row in index._id_to_row.items()}


def identifier_order(kb) -> list[str]:
    """The identifier documents in the order the KB ranks them for the
    identifier query (dense, top 50; a document it does not return is last)."""
    hits = asyncio.run(kb.retriever.retrieve(IDENTIFIER_QUERY, top_k=50, similarity_threshold=0.0))
    ranked = [h.chunk.document_id for h in hits if h.chunk.document_id in IDENTIFIER_DOCS]
    return list(dict.fromkeys(ranked + list(IDENTIFIER_DOCS)))


def check_encoder_answers(got, ref, what: str) -> float:
    """ENC_TOL rule: finite scores; per query the same top chunk, or one the
    reference ranks in its top 5 within ENC_TOL of its top score (a
    near-tie bf16 rounding can swap); the scores of equal ranks within
    ENC_TOL. Returns the max score difference."""
    err = 0.0
    for (query, _), hits, ref_hits in zip(QUERIES + [HYBRID_QUERY], got, ref):
        check(len(hits) > 0 and all(np.isfinite(r.score) for r in hits), f"{what}: {query!r}")
        ref_scores = {r.chunk.id: r.score for r in ref_hits}
        top = hits[0].chunk.id
        check(top == ref_hits[0].chunk.id
              or (top in ref_scores and ref_hits[0].score - ref_scores[top] <= ENC_TOL),
              f"{what}: {query!r} top chunk {top} is not the reference's {ref_hits[0].chunk.id}")
        err = max(err, max(abs(a.score - b.score) for a, b in zip(hits, ref_hits)))
    check(err <= ENC_TOL, f"{what}: scores differ by {err}")
    return err


# 4b (a)'s depth: the default encoder's width at 2 of its 12 layers. At 12
# its CPU twin took 128.2 s of 4b's 132.0 and the script 998.8 s of its
# 1,200 on an NVIDIA H100 80GB HBM3, 700.00 W (the card's host is shared:
# the phases other than 4b and 5f took 1.12x their time on an earlier
# run, and 1.32x on the slowest run seen), so it went to 4; at 4 the twin
# took 44.7 s and the script 1,033 s once 4h (g) and 4k came in, so it went
# to 2 (every layer runs the same kernel at the same shapes); 4d and 5b keep
# the 12-layer default.
ENC4B_LAYERS = 2


def encoder_corpus(seed: int) -> tuple[dict, dict[str, float]]:
    """4b: (a) the default encoder's width at ENC4B_LAYERS layers, (b)
    yrt_tiny_lex. Returns ((a)'s KB's default 12-layer embedder, which 4d
    and 5b take, and (a)'s main-path launch counts; the max differences)."""
    import dataclasses

    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.models.encoder import EncoderConfig
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase

    errs = {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        write_corpus(root, seed)
        for name, text in IDENTIFIER_DOCS.items():
            with open(os.path.join(root, name), "w") as f:
                f.write(text)
        files = sorted(os.path.join(root, f) for f in os.listdir(root))

        # (a) the default encoder through a CUDA KB, against its CPU twin
        t0 = time.perf_counter()
        kb = KnowledgeBase("smoke-enc", encoder_config("smoke-enc"), device="cuda")
        default = kb.embedder
        check(default.cfg == EncoderConfig(attention_impl="pallas"),
              f"the CUDA KB's default encoder is {default.cfg}")
        cfg = dataclasses.replace(default.cfg, n_layers=ENC4B_LAYERS)
        serve_with(kb, TorchEmbedder(config=cfg, device="cuda"))
        reset_launches()
        status, got = asyncio.run(_drive_kb(kb, files))
        order = identifier_order(kb)
        torch.cuda.synchronize()
        counts = attention_counts()
        t_card = time.perf_counter() - t0
        check(status.status == "completed" and not status.errors, f"build failed: {status.errors}")
        print(f"(a) default encoder {cfg.d_model} x {cfg.n_layers} layers on CUDA: "
              f"{status.total_chunks} chunks, launches {counts}, topk {launch_counts()}, "
              f"{t_card:.1f} s")
        n_bw = counts["blockwise_attention"]
        check(n_bw > 0 and n_bw % cfg.n_layers == 0 and counts["flash_attention"] == 0,
              f"(a) attention launches {counts}: want blockwise a positive multiple of "
              f"{cfg.n_layers}, no flash")
        main_counts = counts
        t0 = time.perf_counter()
        twin = KnowledgeBase("smoke-enc-cpu", encoder_config("smoke-enc-cpu"), device="cpu")
        serve_with(twin, TorchEmbedder(config=cfg, params=kb.embedder.params, device="cpu"))
        _, ref = asyncio.run(_drive_kb(twin, files))
        print(f"  CPU twin (the kernels' plain versions): {time.perf_counter() - t0:.1f} s")
        for (query, _), hits in zip(QUERIES + [HYBRID_QUERY], got):
            print(f"  {query!r} -> {hits[0].chunk.document_id} ({hits[0].score:.4f})")
        vecs, ref_vecs = stored_vectors(kb), stored_vectors(twin)
        check(vecs.keys() == ref_vecs.keys(), "(a) the CUDA and CPU KBs hold different chunks")
        emb_err = max(float(np.abs(v - ref_vecs[c]).max()) for c, v in vecs.items())
        check(emb_err <= ENC_TOL, f"(a) stored embeddings differ by {emb_err} > {ENC_TOL}")
        errs["a"] = max(emb_err, check_encoder_answers(got, ref, "(a) CUDA vs CPU"))
        print(f"  embeddings within {emb_err:.3g} of the CPU twin's, answers within the rule; "
              f"identifier order {order} (CPU {identifier_order(twin)})")

        # (b) yrt_tiny_lex as its config says, then through the kernels
        yrt = KnowledgeBase("smoke-yrt", encoder_config("smoke-yrt", WEIGHTS), device="cuda")
        check(yrt.embedder.cfg.attention_impl == "xla", "yrt_tiny_lex is not served as 'xla'")
        reset_launches()
        status, got = asyncio.run(_drive_kb(yrt, files))
        order = identifier_order(yrt)
        torch.cuda.synchronize()
        counts = attention_counts()
        check(sum(counts.values()) == 0, f"(b) yrt_tiny_lex as 'xla' launched attention: {counts}")
        check(order == list(IDENTIFIER_DOCS), f"(b) identifier ranking {order}")
        twin = KnowledgeBase("smoke-yrt-cpu", encoder_config("smoke-yrt-cpu", WEIGHTS), device="cpu")
        _, ref = asyncio.run(_drive_kb(twin, files))
        errs["b"] = check_encoder_answers(got, ref, "(b) CUDA vs CPU")
        print(f"(b) yrt_tiny_lex ({yrt.embedder.cfg.attention_impl}): {status.total_chunks} chunks, "
              f"identifier order {order}, same answers as the CPU KB")
        pallas = TorchEmbedder(config=dataclasses.replace(yrt.embedder.cfg, attention_impl="pallas"),
                               params=yrt.embedder.params, device="cuda")
        again = KnowledgeBase("smoke-yrt-pallas", encoder_config("smoke-yrt-pallas", WEIGHTS),
                              device="cuda")
        serve_with(again, pallas)
        before = attention_counts()["blockwise_attention"]
        _, got2 = asyncio.run(_drive_kb(again, files))
        order2 = identifier_order(again)
        torch.cuda.synchronize()
        n_bw = attention_counts()["blockwise_attention"] - before
        check(n_bw > 0, "(b) yrt_tiny_lex with 'pallas' never launched blockwise_attention")
        check([h[0].chunk.document_id for h in got2] == [h[0].chunk.document_id for h in got],
              "(b) 'pallas' and 'xla' serving give other top documents")
        check(order2 == list(IDENTIFIER_DOCS), f"(b) 'pallas' identifier ranking {order2}")
        errs["b"] = max(errs["b"], check_encoder_answers(got2, got, "(b) pallas vs xla"))
        print(f"  served again with 'pallas': {n_bw} blockwise launches, same top documents "
              f"and identifier order")
    return {"embedder": default, "launches": main_counts}, errs


# ---------------------------------------------------------------------------
# 4d. main path, small corpus, long documents
# ---------------------------------------------------------------------------

LONG_LEAD = 640  # shared filler words before each document's passage: past token 512
LONG_REPEATS = 50  # the passage's sentence, repeated: the document's own content
LONG_DOCS = ("cooking.md", "astronomy.md", "cycling.md", "gardening.md", "chess.md", "coffee.md")
LONG_QUERIES = QUERIES[1:] + [HYBRID_QUERY, ("how does castling move the king", "chess.md"),
                              ("espresso extraction seconds at nine bar", "coffee.md")]
SMALL_ENC = dict(d_model=128, n_layers=2, n_heads=2, d_ff=512, out_dim=128)  # 2 heads of 64


def write_long_corpus(root: str, seed: int) -> None:
    """One file per LONG_DOCS topic, under 10,000 characters (one chunk at
    ``chunk_size`` 10,000): a title, LONG_LEAD filler words that every
    document shares, then the topic's sentence LONG_REPEATS times, so the
    text that tells the documents apart starts past token 512."""
    rng = np.random.default_rng(seed)
    for name in LONG_DOCS:
        title, sentence = TOPICS[name].split("\n", 1)
        lead = " ".join(rng.choice(FILLER, size=LONG_LEAD))
        with open(os.path.join(root, name), "w") as f:
            f.write(f"{title}\n\n{lead}.\n\n" + " ".join([sentence] * LONG_REPEATS))


def long_config(name: str):
    from youtu_rag_tpu_torch.core.config import ChunkingConfig

    cfg = encoder_config(name)
    cfg.knowledge_builder.chunking = ChunkingConfig(chunk_size=10000)
    return cfg


async def _long_answers(kb):
    return [await kb.retriever.retrieve(q, top_k=3, similarity_threshold=0.0)
            for q, _ in LONG_QUERIES]


def long_kb(name: str, embedder, files, device: str):
    """A KB of the long corpus served by ``embedder``: (status, answers)."""
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase

    kb = KnowledgeBase(name, long_config(name), device=device)
    serve_with(kb, embedder)
    status = asyncio.run(kb.build_files(files))
    check(status.status == "completed" and not status.errors, f"{name}: build {status.errors}")
    check(status.total_chunks == len(LONG_DOCS), f"{name}: {status.total_chunks} chunks, "
          f"want one per document")
    return kb, asyncio.run(_long_answers(kb))


def long_corpus(seed: int, embedder) -> dict:
    """4d: the default full-width encoder with sp_mesh=4 answers from the
    right documents; a small encoder's KB on the card gives the top
    documents of its CPU twin. Returns the full-width embedder and its
    main-path launch counts."""
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.models.encoder import EncoderConfig

    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        write_long_corpus(root, seed)
        files = sorted(os.path.join(root, f) for f in os.listdir(root))
        tok = embedder.tokenizer
        for path in files:
            with open(path) as f:
                ids = tok.tokenize(f.read())
            check(len(ids) + 2 > embedder.cfg.max_len, f"{path}: only {len(ids)} tokens")
        lead_tokens = len(tok.tokenize(f"{TOPICS[LONG_DOCS[0]].split(chr(10))[0]} "
                                       + " ".join(["notes"] * LONG_LEAD) + ".")) + 1
        check(lead_tokens > 512, f"the passages start at token {lead_tokens}")

        # the default encoder, sequence-parallel over 4 shards on the card
        t0 = time.perf_counter()
        cfg = embedder.cfg
        long_emb = TorchEmbedder(config=cfg, params=embedder.params, device="cuda", sp_mesh=4)
        reset_launches()
        kb, got = long_kb("smoke-long", long_emb, files, "cuda")
        torch.cuda.synchronize()
        counts = attention_counts()
        n_stats = counts["flash_attention_stats"]
        lens = sorted(len(tok.tokenize(c.content)) + 2 for c in kb.store.index._chunks if c)
        print(f"long corpus: {len(files)} documents of {lens[0]}-{lens[-1]} tokens, one chunk "
              f"each, passages from token {lead_tokens}; default encoder, sp_mesh=4: launches "
              f"{counts}, {time.perf_counter() - t0:.1f} s")
        check(n_stats > 0 and n_stats % (cfg.n_layers * 4) == 0,
              f"flash_attention_stats launches {n_stats}: want a positive multiple of "
              f"{cfg.n_layers} x 4")
        for (query, want), hits in zip(LONG_QUERIES, got):
            check(len(hits) > 0 and all(np.isfinite(h.score) for h in hits), f"{query!r}: hits")
            print(f"  {query!r} -> {hits[0].chunk.document_id} ({hits[0].score:.4f}; next "
                  f"{hits[1].chunk.document_id} {hits[1].score:.4f})")
            check(hits[0].chunk.document_id == want,
                  f"{query!r}: top document {hits[0].chunk.document_id}, expected {want}")
        out["launches"] = n_stats
        # the same KB cut at max_len, for contrast (no check)
        _, cut = long_kb("smoke-long-cut", TorchEmbedder(config=cfg, params=embedder.params,
                                                         device="cuda"), files, "cuda")
        right = sum(h[0].chunk.document_id == w for (_, w), h in zip(LONG_QUERIES, cut))
        print(f"  cut at max_len {cfg.max_len} (no sp_mesh): {right} of {len(LONG_QUERIES)} "
              "queries answered from the right document")

        # a small encoder (Tl >= 256 still takes the hop kernel): card vs CPU twin
        small_cfg = EncoderConfig(**SMALL_ENC, attention_impl="pallas")
        small = TorchEmbedder(config=small_cfg, device="cuda", sp_mesh=4)
        before = attention_counts()["flash_attention_stats"]
        _, got_s = long_kb("smoke-long-small", small, files, "cuda")
        torch.cuda.synchronize()
        n_small = attention_counts()["flash_attention_stats"] - before
        check(n_small > 0 and n_small % (small_cfg.n_layers * 4) == 0,
              f"small encoder: flash_attention_stats launches {n_small}")
        twin = TorchEmbedder(config=small_cfg, params=small.params, device="cpu", sp_mesh=4)
        _, ref_s = long_kb("smoke-long-small-cpu", twin, files, "cpu")
        tops = [h[0].chunk.document_id for h in got_s]
        check(tops == [h[0].chunk.document_id for h in ref_s],
              f"small encoder: card {tops}, CPU twin {[h[0].chunk.document_id for h in ref_s]}")
        err = max(abs(a.score - b.score) for g, r in zip(got_s, ref_s) for a, b in zip(g, r))
        check(err <= ENC_TOL, f"small encoder: scores differ from the CPU twin's by {err}")
        print(f"  small encoder ({small_cfg.d_model} wide, {small_cfg.n_layers} layers, "
              f"{small_cfg.n_heads} heads of {small_cfg.head_dim}), sp_mesh=4: {n_small} hop "
              f"launches, the CPU twin's top documents {tops}, scores within {err:.3g}")
    out["embedder"] = long_emb
    return out


# ---------------------------------------------------------------------------
# 4e. main path, small corpus, a pretrained BERT-family checkpoint
# ---------------------------------------------------------------------------

# BAAI/bge-base-en-v1.5's config.json (BERT-base: CLS pooling, from its
# 1_Pooling/config.json); the cross-encoder has google-bert/bert-base-uncased's
# widths as a BertForSequenceClassification with one label
BERT_BASE = {"model_type": "bert", "vocab_size": 30522, "hidden_size": 768,
             "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
             "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
             "hidden_act": "gelu", "hidden_dropout_prob": 0.1,
             "attention_probs_dropout_prob": 0.1, "initializer_range": 0.02, "pad_token_id": 0}
BERT_SPECIAL = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
BERT_PIECES = ("##s", "##es", "##ed", "##ing", "##ly", "##er")
BERT_WORDS = 430  # filler words per document: one chunk of ~450-500 tokens (the T = 512 bucket)


def write_safetensors(path: str, tensors: dict[str, np.ndarray], dtype: str) -> None:
    """The safetensors layout (an 8-byte little-endian header length, a JSON
    header padded to 8 bytes, the tensors' bytes), F32 or BF16 (rounded to
    nearest even by torch)."""
    import struct

    header, offset, names = {}, 0, sorted(tensors)
    for name in names:
        nbytes = tensors[name].size * (4 if dtype == "F32" else 2)
        header[name] = {"dtype": dtype, "shape": list(tensors[name].shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    h = json.dumps(header, separators=(",", ":")).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h)
        for name in names:
            a = np.ascontiguousarray(tensors[name], np.float32)
            if dtype == "BF16":
                a = torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy()
            f.write(a.tobytes())


def write_bert_checkpoint(d: str, vocab: list[str], seed: int, head: bool, dtype: str) -> None:
    """A BERT-base checkpoint directory in the Hugging Face layout: weights
    and biases N(0, 0.02^2) from ``seed``, LayerNorms 1 and 0; BertModel's
    keys with its pooler and CLS pooling (an embedder), or with ``head``
    under ``bert.`` with a one-label ``classifier`` (a cross-encoder)."""
    rng = np.random.default_rng(seed)
    hd, inter, vsz = BERT_BASE["hidden_size"], BERT_BASE["intermediate_size"], len(vocab)

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    sd = {"embeddings.word_embeddings.weight": w(vsz, hd),
          "embeddings.position_embeddings.weight": w(BERT_BASE["max_position_embeddings"], hd),
          "embeddings.token_type_embeddings.weight": w(BERT_BASE["type_vocab_size"], hd)}
    lns = ["embeddings.LayerNorm"]
    for i in range(BERT_BASE["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name, (o, n) in (("attention.self.query", (hd, hd)), ("attention.self.key", (hd, hd)),
                             ("attention.self.value", (hd, hd)),
                             ("attention.output.dense", (hd, hd)),
                             ("intermediate.dense", (inter, hd)), ("output.dense", (hd, inter))):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = w(o, n), w(o)
        lns += [p + "attention.output.LayerNorm", p + "output.LayerNorm"]
    for ln in lns:
        sd[ln + ".weight"], sd[ln + ".bias"] = np.ones(hd, np.float32), np.zeros(hd, np.float32)
    sd["pooler.dense.weight"], sd["pooler.dense.bias"] = w(hd, hd), w(hd)
    cfg = dict(BERT_BASE, vocab_size=vsz, architectures=["BertModel"])
    if head:
        sd = {"bert." + k: v for k, v in sd.items()}
        sd["classifier.weight"], sd["classifier.bias"] = w(1, hd), w(1)
        cfg.update(architectures=["BertForSequenceClassification"], id2label={"0": "LABEL_0"},
                   label2id={"LABEL_0": 0})
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    write_safetensors(os.path.join(d, "model.safetensors"), sd, dtype)
    with open(os.path.join(d, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    if not head:
        os.makedirs(os.path.join(d, "1_Pooling"), exist_ok=True)
        with open(os.path.join(d, "1_Pooling", "config.json"), "w") as f:
            json.dump({"word_embedding_dimension": hd, "pooling_mode_cls_token": True,
                       "pooling_mode_mean_tokens": False}, f)


def bert_vocab(texts: list[str]) -> list[str]:
    """A 30,522-entry vocab.txt: the special tokens, the texts' words (as
    BERT's basic tokenizer splits them), their characters bare and as
    ``##`` pieces, a few suffixes, then ``[unusedN]`` filler."""
    from youtu_rag_tpu_torch.models.wordpiece import WordPieceTokenizer

    basic = WordPieceTokenizer({"[UNK]": 0, "[CLS]": 1, "[SEP]": 2}, use_fast=False)
    words = sorted({w for t in texts for w in basic.basic_tokenize(t)})
    chars = sorted({c for w in words for c in w})
    vocab = list(dict.fromkeys([*BERT_SPECIAL, *words, *chars, *("##" + c for c in chars),
                                *BERT_PIECES]))
    return vocab + [f"[unused{i}]" for i in range(BERT_BASE["vocab_size"] - len(vocab))]


def write_bert_corpus(root: str, seed: int) -> None:
    """Phase 4's topics, one chunk each: the topic's text, then BERT_WORDS
    filler words."""
    rng = np.random.default_rng(seed + 11)
    for name, text in TOPICS.items():
        with open(os.path.join(root, name), "w") as f:
            f.write(text + "\n\n" + " ".join(rng.choice(FILLER, size=BERT_WORDS)) + ".")


def bert_config(name: str, pretrained_dir: str | None):
    """One chunk per document; the pretrained embedder (a twin without
    ``pretrained_dir`` is served its embedder by ``serve_with``)."""
    from youtu_rag_tpu_torch.core.config import ChunkingConfig, EmbeddingConfig, RAGConfig

    cfg = RAGConfig(name=name)
    if pretrained_dir:
        cfg.knowledge_builder.embedding = EmbeddingConfig(provider="tpu",
                                                          pretrained_dir=pretrained_dir)
    cfg.knowledge_builder.chunking = ChunkingConfig(chunk_size=10000)
    return cfg


class ForwardSpy:
    """Stands in for ``encode_tokens`` / ``rerank_scores`` in a module and
    records the T of every call."""

    def __init__(self, module, name: str):
        self.module, self.name, self.fn, self.ts = module, name, getattr(module, name), []

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def __call__(self, params, token_ids, *args, **kw):
        self.ts.append(int(token_ids.shape[1]))
        return self.fn(params, token_ids, *args, **kw)


def forward_split(fn) -> dict[str, float]:
    """One call's device time by kernel kind (torch.profiler): the blockwise
    attention kernel, the GEMMs (cuBLAS) and the rest (elementwise, norms,
    copies); ms each."""
    split = {"attention kernel": 0.0, "GEMMs": 0.0, "elementwise and the rest": 0.0}
    for name, (_, us) in device_kernels(fn, 1).items():
        low = name.lower()
        kind = ("attention kernel" if "attention_kernel" in low else
                "GEMMs" if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass")) else
                "elementwise and the rest")
        split[kind] += us / 1e3
    return split


def check_ranking(got: list[tuple[str, float]], ref: list[tuple[str, float]], tol: float,
                  what: str) -> float:
    """The same items in the same order, but for a swap of two whose
    reference scores lie within ``tol``; scores within ``tol``. Returns the
    max score difference."""
    scores = dict(ref)
    err = 0.0
    for (item, s), (want, ws) in zip(got, ref):
        check(item in scores and np.isfinite(s), f"{what}: {item} is not among {list(scores)}")
        err = max(err, abs(s - scores[item]))
        check(item == want or abs(scores[item] - ws) <= tol,
              f"{what}: {item} ranks where the reference has {want} ({scores[item]} vs {ws})")
    check(err <= tol, f"{what}: scores differ by {err} > {tol}")
    return err


def bert_corpus(seed: int, smi: str) -> dict:
    """4e: a BERT-base embedder and cross-encoder written from a seed,
    served through ``EmbeddingConfig(provider="tpu", pretrained_dir=...)``
    and ``TorchReranker.from_pretrained`` on the card, held against CPU f32
    twins of the same checkpoints; then BERT-base throughput. Returns the
    main path's blockwise launches and the max differences."""
    import dataclasses

    import youtu_rag_tpu_torch.models.embedder as embedder_mod
    import youtu_rag_tpu_torch.models.encoder as encoder_mod
    import youtu_rag_tpu_torch.models.reranker as reranker_mod
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.models.encoder import encode_tokens, rerank_scores
    from youtu_rag_tpu_torch.models.reranker import TorchReranker
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase

    out, errs = {}, {}
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=repo) as root:
        docs = os.path.join(root, "docs")
        os.makedirs(docs)
        write_bert_corpus(docs, seed)
        files = sorted(os.path.join(docs, f) for f in os.listdir(docs))
        texts = [open(p).read() for p in files] + [q for q, _ in QUERIES]
        t0 = time.perf_counter()
        vocab = bert_vocab(texts)
        emb_dir, rr_dir = os.path.join(root, "bge-base"), os.path.join(root, "reranker-base")
        write_bert_checkpoint(emb_dir, vocab, seed + 1, head=False, dtype="F32")
        write_bert_checkpoint(rr_dir, vocab, seed + 2, head=True, dtype="BF16")
        print(f"BERT-base checkpoints written (embedder F32, cross-encoder BF16; vocab.txt "
              f"{len(vocab)} entries): {time.perf_counter() - t0:.1f} s")

        # the CUDA KB through the user's entry points, the cross-encoder in its retriever
        t0 = time.perf_counter()
        kb = KnowledgeBase("smoke-bert", bert_config("smoke-bert", emb_dir), device="cuda")
        rr = TorchReranker.from_pretrained(rr_dir, device="cuda")
        for part in (kb, kb.retriever, kb.hybrid_retriever):
            part.reranker = rr
        cfg = kb.embedder.cfg
        check(isinstance(kb.embedder, TorchEmbedder) and cfg.arch == "bert"
              and cfg.attention_impl == "pallas" and cfg.pooling == "cls"
              and cfg.dtype == torch.bfloat16 and cfg.gelu_approximate is False
              and cfg.ln_eps == 1e-12 and (cfg.d_model, cfg.n_layers, cfg.n_heads) == (768, 12, 12),
              f"the pretrained embedder's config: {cfg}")
        check(rr.cfg.attention_impl == "pallas" and "score_head" in rr.params
              and "pooler_w" in rr.params, "the cross-encoder's config or head")
        reset_launches()
        with ForwardSpy(embedder_mod, "encode_tokens") as fe, \
                ForwardSpy(reranker_mod, "rerank_scores") as fr, \
                LastCallOn(encoder_mod, "blockwise_attention") as attn:
            status = asyncio.run(kb.build_files(files))
            dense = [asyncio.run(kb.retriever.retrieve(q, top_k=len(files),
                                                       similarity_threshold=0.0))
                     for q, _ in QUERIES]
            reranked = [asyncio.run(kb.retriever.retrieve(q, top_k=3, similarity_threshold=0.0,
                                                          enable_reranking=True))
                        for q, _ in QUERIES]
            torch.cuda.synchronize()
        counts = attention_counts()
        t_card = time.perf_counter() - t0
        check(status.status == "completed" and status.total_chunks == len(files),
              f"bert KB build: {status.total_chunks} chunks, errors {status.errors}")
        long_calls = sum(t >= 256 for t in fe.ts + fr.ts)
        check(512 in fe.ts and 512 in fr.ts and min(fe.ts) < 256,
              f"forward T buckets: embedder {fe.ts}, reranker {fr.ts}")
        check(counts["blockwise_attention"] == cfg.n_layers * long_calls
              and counts["flash_attention"] == 0,
              f"attention launches {counts}: want {cfg.n_layers} x {long_calls} forwards at "
              f"T >= 256 (embedder T {fe.ts}, reranker T {fr.ts})")
        out["launches"] = counts["blockwise_attention"]
        print(f"CUDA KB: {status.total_chunks} chunks; forwards: embedder T {fe.ts}, reranker "
              f"T {fr.ts}; blockwise launches {counts['blockwise_attention']} = "
              f"{cfg.n_layers} x {long_calls}; {t_card:.1f} s")

        # G1: the stored embeddings (T = 512) against a CPU f32 twin
        t0 = time.perf_counter()
        twin = KnowledgeBase("smoke-bert-cpu", bert_config("smoke-bert-cpu", None), device="cpu")
        cpu_emb = TorchEmbedder.from_pretrained(emb_dir, dtype=torch.float32, device="cpu")
        serve_with(twin, cpu_emb)
        asyncio.run(twin.build_files(files))
        ref_dense = [asyncio.run(twin.retriever.retrieve(q, top_k=len(files),
                                                         similarity_threshold=0.0))
                     for q, _ in QUERIES]
        vecs, ref_vecs = stored_vectors(kb), stored_vectors(twin)
        check(vecs.keys() == ref_vecs.keys() and len(vecs) >= 16, "the bert KBs' chunks")
        check(all(np.isfinite(v).all() for v in vecs.values()), "non-finite embeddings")
        errs["embeddings"] = max(float(np.abs(v - ref_vecs[c]).max()) for c, v in vecs.items())
        check(errs["embeddings"] <= ENC_TOL,
              f"{len(vecs)} embeddings at T = 512 differ from the CPU f32 forward's by "
              f"{errs['embeddings']} > {ENC_TOL}")
        # G4: the dense ranking of every document, near-ties aside
        for (query, _), got, ref in zip(QUERIES, dense, ref_dense):
            errs["dense"] = max(errs.get("dense", 0.0), check_ranking(
                [(h.chunk.document_id, h.score) for h in got],
                [(h.chunk.document_id, h.score) for h in ref], ENC_TOL, f"dense {query!r}"))
        print(f"  CPU f32 twin: {len(vecs)} stored embeddings within {errs['embeddings']:.3g} "
              f"(ENC_TOL {ENC_TOL}); dense rankings within {errs['dense']:.3g}; "
              f"{time.perf_counter() - t0:.1f} s")

        # G2: the same CUDA forward with plain attention ("xla")
        xla = TorchEmbedder(config=dataclasses.replace(cfg, attention_impl="xla"),
                            params=kb.embedder.params, tokenizer=kb.embedder.tokenizer,
                            device="cuda")
        chunks = {c.id: c.content for c in kb.store.index._chunks if c}
        ids = sorted(chunks)
        plain_vecs = xla.embed_batch([chunks[c] for c in ids])
        errs["xla"] = float(max(np.abs(plain_vecs[i] - vecs[c]).max() for i, c in enumerate(ids)))
        check(np.isfinite(plain_vecs).all() and errs["xla"] <= ENC_TOL,
              f"the forward with plain attention differs by {errs['xla']}")
        q, k, v, bias = attn.args  # the last blockwise call of the path: the last reranker layer
        mask = (bias == 0).float()
        errs["attention"] = compare_attention(
            encoder_mod._attention_core(q, k, v, mask, dataclasses.replace(rr.cfg,
                                                                           attention_impl="pallas")),
            encoder_mod._attention_core(q, k, v, mask, dataclasses.replace(rr.cfg,
                                                                           attention_impl="xla")),
            f"blockwise against plain attention on the path's [{', '.join(map(str, q.shape))}]")
        print(f"  plain-attention ('xla') CUDA forward: embeddings within {errs['xla']:.3g}; the "
              f"kernel's attention output within one bf16 ulp of plain attention "
              f"({errs['attention']:.3g}) on the last layer's strided q, k, v")

        # G3: the cross-encoder's scores on the path's candidates, against a CPU f32 twin
        t0 = time.perf_counter()
        rr_cpu = TorchReranker.from_pretrained(rr_dir, dtype=torch.float32, device="cpu")
        for (query, _), ranked, final in zip(QUERIES, dense, reranked):
            cands = ranked[: 2 * len(final)]  # the retriever's recall before the rerank
            cand = [h.chunk.content for h in cands]
            got, ref = rr.score(query, cand), rr_cpu.score(query, cand)
            order = sorted(range(len(cand)), key=lambda i: -ref[i])
            errs["rerank"] = max(errs.get("rerank", 0.0), check_ranking(
                sorted([(i, got[i]) for i in range(len(cand))], key=lambda t: -t[1]),
                [(i, ref[i]) for i in order], ENC_TOL, f"rerank {query!r}"))
            by_content = {h.chunk.content: i for i, h in enumerate(cands)}
            top = [by_content[h.chunk.content] for h in final]
            check(top == sorted(range(len(cand)), key=lambda i: -got[i])[: len(top)],
                  f"rerank {query!r}: the retriever's order is not its scores'")
            print(f"  {query!r}: dense top {cands[0].chunk.document_id} ({cands[0].score:.5f}), "
                  f"reranked top {final[0].chunk.document_id} ({final[0].score:.4f}; CPU "
                  f"{ref[top[0]]:.4f})")
        print(f"  cross-encoder scores within {errs['rerank']:.3g} of the CPU f32 twin's "
              f"(ENC_TOL), the same order where they are further apart; "
              f"{time.perf_counter() - t0:.1f} s")

        # throughput: B = 128, T = 512 embeddings; B = 64, T = 512 pairs
        rng = np.random.default_rng(seed + 12)
        words = np.array([w for w in vocab[len(BERT_SPECIAL):] if w.isalpha() and len(w) > 1])
        big = [" ".join(rng.choice(words, size=600)) for _ in range(128)]
        emb = kb.embedder
        emb.embed_batch(big[:8])  # warm-up
        t0 = time.perf_counter()
        tok_ids, tok_mask = emb.tokenizer.batch(big)
        t_tok = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        vec = emb.embed_batch(big)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_bw = attention_counts()["blockwise_attention"]
        check(vec.shape == (128, 768) and np.isfinite(vec).all() and n_bw == cfg.n_layers,
              f"B = 128 embed: {vec.shape}, {n_bw} blockwise launches")
        check(tok_ids.shape == (128, 512), f"B = 128 batch: {tok_ids.shape}")
        ids_d, mask_d = torch.from_numpy(tok_ids).cuda(), torch.from_numpy(tok_mask).cuda()
        fwd = lambda: encode_tokens(emb.params, ids_d, mask_d, cfg)  # noqa: E731
        fwd_ms = time_ms(fwd, bursts=3, burst=3, warmup=1)
        split = forward_split(fwd)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        real = encoder_mod.blockwise_attention
        encoder_mod.blockwise_attention = lambda q, k, v, b: sdpa(  # noqa: E731
            q, k, v, attn_mask=torch.clamp_min(b, -1e30).to(q.dtype)[:, None, None, :])
        try:
            sdpa_ms = time_ms(fwd, bursts=3, burst=3, warmup=1)
        finally:
            encoder_mod.blockwise_attention = real
        out["embed"] = {"fwd_ms": fwd_ms, "wall_ms": wall * 1e3, "tok_ms": t_tok * 1e3,
                        "sdpa_ms": sdpa_ms, "split": split}
        path = "pure-Python" if emb.tokenizer._fast is None else "tokenizers"
        print(f"BERT-base embeddings, B = 128, T = 512 [{smi}]: forward {fwd_ms:.4f} ms device "
              f"({128 / fwd_ms * 1e3:.1f} embeddings/s); embed_batch {wall * 1e3:.1f} ms wall "
              f"({128 / wall:.1f} embeddings/s; WordPiece alone, {path} path, "
              f"{t_tok * 1e3:.1f} ms); the forward with SDPA in the kernel's place "
              f"{sdpa_ms:.4f} ms")
        total = sum(split.values())
        print("  forward split (torch.profiler, one call): " + ("; ".join(
            f"{kind} {ms:.4f} ms ({ms / total:.0%})" for kind, ms in split.items())
            + f"; {total:.4f} ms of kernels" if total else "no device events recorded"))
        pairs = [" ".join(rng.choice(words, size=600)) for _ in range(64)]
        rr.score(QUERIES[0][0], pairs[:8])  # warm-up
        reset_launches()
        t0 = time.perf_counter()
        scores = rr.score(QUERIES[0][0], pairs)
        torch.cuda.synchronize()
        r_wall = time.perf_counter() - t0
        n_bw = attention_counts()["blockwise_attention"]
        check(len(scores) == 64 and np.isfinite(scores).all() and n_bw == rr.cfg.n_layers,
              f"B = 64 rerank: {n_bw} blockwise launches")
        p_ids, p_mask, p_types = (torch.from_numpy(a).cuda()
                                  for a in rr._bucket(pairs, QUERIES[0][0]))
        check(tuple(p_ids.shape) == (64, 512), f"B = 64 pairs: {tuple(p_ids.shape)}")
        r_ms = time_ms(lambda: rerank_scores(rr.params, p_ids, p_mask, rr.cfg, type_ids=p_types),
                       bursts=3, burst=3, warmup=1)
        out["rerank"] = {"fwd_ms": r_ms, "wall_ms": r_wall * 1e3}
        print(f"BERT-base cross-encoder, B = 64 pairs, T = 512 [{smi}]: {r_ms:.4f} ms device "
              f"({64 / r_ms * 1e3:.1f} pairs/s); score() {r_wall * 1e3:.1f} ms wall "
              f"({64 / r_wall:.1f} pairs/s, WordPiece included)")
    out["errs"] = errs
    return out


# ---------------------------------------------------------------------------
# 4f. main path, ingest through the staged builder
# ---------------------------------------------------------------------------

# 4f's files: 1,024, cut from 2,048 (the hash build and its CPU twin took
# ~40 s of a 1,190-s run of the script on an NVIDIA H100 80GB HBM3, 700.00
# W, whose 1,200-s limit it must keep; the gates are the same)
INGEST_DOCS = 1024
INGEST_CHARS = 6000  # per file: ~8 chunks of the default ChunkingConfig (1,000 / 200)
INGEST_QUESTIONS = 64
INGEST_REWRITTEN = 16
INGEST_CLEANED = 8
INGEST_ENC_DOCS = 256
# 4f (c)'s stored embeddings held against the CPU twin's forward (768 x 12,
# T = 256, 0.41 s each on the card's host): 16, cut from 64, which took
# 26.5 s of the script's 1,033 s on an NVIDIA H100 80GB HBM3, 700.00 W once
# 4h (g) and 4k came in; every one is a chunk's whole forward.
INGEST_ENC_CHECKED = 16
INGEST_SYLLABLES = np.array([c + v for c in "bcdfghklmnprstvz" for v in "aeiou"])
INGEST_KINDS = ("code", "number", "period", "rating", "index", "channel", "berth", "total")


def ingest_words(rng, n: int) -> list[str]:
    """``n`` words of two or three syllables."""
    k = rng.integers(2, 4, size=n)
    return ["".join(row[:m]) for row, m in zip(rng.choice(INGEST_SYLLABLES, size=(n, 3)), k)]


def write_ingest_corpus(root: str, seed: int, version: int = 0,
                        names: list[str] | None = None, n_docs: int = INGEST_DOCS,
                        chars: int = INGEST_CHARS) -> list[tuple[str, str]]:
    """``n_docs`` markdown files of ~``chars`` characters: a title that
    names the document's entity, one fact sentence ("The <attr> of <entity>
    is <value>."; entity and attribute words belong to this document
    alone), then paragraphs of sentences over a shared vocabulary of 8,000
    words (each sentence 8-16 words, so every 1,000-character chunk holds
    130-250 tokens: T = 256 at the encoder). ``version`` draws other
    paragraphs; ``names`` limits the files written. Returns (file name,
    fact question) per document."""
    rng = np.random.default_rng(seed)
    vocab = np.array(sorted(set(ingest_words(rng, 8000))))
    entities = sorted({w.capitalize() for w in ingest_words(rng, 4 * n_docs)})
    rng.shuffle(entities)
    attrs = sorted(set(ingest_words(rng, 4 * n_docs)) - {e.lower() for e in entities})
    rng.shuffle(attrs)
    facts = []
    for i in range(n_docs):
        name = f"doc{i:04d}.md"
        ent = f"{entities[2 * i]} {entities[2 * i + 1]}"
        attr = f"{attrs[i]} {INGEST_KINDS[i % len(INGEST_KINDS)]}"
        facts.append((name, f"What is the {attr} of {ent}?"))
        value = int(rng.integers(10_000, 100_000))
        if names is not None and name not in names:
            continue
        frng = np.random.default_rng([seed, i, version])
        text = f"# {ent}\n\nThe {attr} of {ent} is {value}."
        sentences, size = [], len(text) + 2
        while size < chars:
            s = " ".join(vocab[frng.integers(0, len(vocab), size=int(frng.integers(8, 17)))])
            sentences.append(s.capitalize() + ".")
            size += len(sentences[-1]) + 1
        text += "\n\n" + "\n\n".join(" ".join(sentences[j:j + 5])
                                      for j in range(0, len(sentences), 5))
        with open(os.path.join(root, name), "w") as f:
            f.write(text)
    return facts


class IngestTimers:
    """Host seconds of the build's parts while active: load and chunk
    (``_load``, ``_content_chunks``, ``_summary_chunk`` of the processors),
    embed (the embedder's ``embed_texts``), lexical update
    (``LexicalInvertedIndex.add``) and index add (``DeviceVectorIndex.add``
    up to its device completion); with the index adds counted."""

    PARTS = ("load and chunk", "embed", "lexical update", "index add")

    def __init__(self, embedder):
        from youtu_rag_tpu_torch.index.device_index import DeviceVectorIndex
        from youtu_rag_tpu_torch.ingest.processors import BaseSourceProcessor
        from youtu_rag_tpu_torch.retrieval.lexical import LexicalInvertedIndex

        self.seconds = dict.fromkeys(self.PARTS, 0.0)
        self.adds = 0
        self._patches = [(BaseSourceProcessor, n, "load and chunk")
                         for n in ("_load", "_content_chunks", "_summary_chunk")]
        self._patches += [(LexicalInvertedIndex, "add", "lexical update"),
                          (DeviceVectorIndex, "add", "index add")]
        self._embedder = embedder

    def _timed(self, fn, part: str):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
                if part == "index add":
                    self.adds += 1
                    if torch.cuda.is_available():
                        torch.cuda.synchronize()
                return out
            finally:
                self.seconds[part] += time.perf_counter() - t0
        return run

    def __enter__(self):
        self._saved = [(cls, name, cls.__dict__[name]) for cls, name, _ in self._patches]
        for cls, name, part in self._patches:
            setattr(cls, name, self._timed(cls.__dict__[name], part))
        embed = self._embedder.embed_texts

        async def timed_embed(texts):
            t0 = time.perf_counter()
            try:
                return await embed(texts)
            finally:
                self.seconds["embed"] += time.perf_counter() - t0

        self._embedder.embed_texts = timed_embed
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)
        del self._embedder.embed_texts


def hybrid_documents(kb, facts) -> list[list[str]]:
    """The documents of each question's hybrid top 5 (dense through the
    kernel, fused with the BM25 index the build filled)."""
    return [[h.chunk.document_id for h in asyncio.run(
        kb.hybrid_retriever.retrieve(q, top_k=5, similarity_threshold=0.0))] for _, q in facts]


def dense_pools(kb, facts, k: int = 50) -> list:
    return [asyncio.run(kb.retriever.retrieve(q, top_k=k, similarity_threshold=0.0))
            for _, q in facts]


def same_up_to_ties(got, ref, tol: float) -> bool:
    """The same chunk at each rank with scores within ``tol``, except that
    chunks whose reference scores lie within ``tol`` of each other may trade
    places (the kernel sums in f32 in another order than its plain
    version); the last rank may hold a chunk the reference ranks next."""
    if len(got) != len(ref):
        return False
    ref_score = {r.chunk.id: r.score for r in ref}
    for g, r in zip(got, ref):
        if abs(g.score - r.score) > tol:
            return False
        if g.chunk.id != r.chunk.id and abs(ref_score.get(g.chunk.id, np.inf) - r.score) > tol:
            return False
    return True


def stored_rows(kb, ids: list[str]) -> torch.Tensor:
    index = kb.store.index
    rows = torch.tensor([index._id_to_row[c] for c in ids], device=index._vectors.device)
    return index._vectors[rows].cpu()


def ingest_corpus(seed: int, smi: str) -> dict:
    """4f: INGEST_DOCS markdown files through ``KnowledgeBase.build_sources`` on
    the card: (a) the hash provider against a CPU twin, (b) incremental
    builds and cleanup, (c) the encoder provider over the first 256 files.
    Returns the main path's launches and the numbers printed."""
    import dataclasses
    import importlib.util

    import youtu_rag_tpu_torch.models.embedder as embedder_mod
    import youtu_rag_tpu_torch.models.tokenizer as tokenizer_mod
    from youtu_rag_tpu_torch.core.config import EmbeddingConfig, RAGConfig
    from youtu_rag_tpu_torch.ingest.chunker import get_splitter
    from youtu_rag_tpu_torch.ingest.cleanup import KnowledgeCleanupManager
    from youtu_rag_tpu_torch.ingest.loaders import DocumentLoaderRegistry
    from youtu_rag_tpu_torch.ingest.processors import SourceTask
    from youtu_rag_tpu_torch.models.embedder import HashEmbedder, TorchEmbedder
    from youtu_rag_tpu_torch.models.encoder import EncoderConfig
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase

    print(f"pandas importable on this host: {importlib.util.find_spec('pandas') is not None} "
          "(table, QA-file and database sources are held on the CPU tests only)")
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        t0 = time.perf_counter()
        facts = write_ingest_corpus(root, seed)
        print(f"{INGEST_DOCS} files of ~{INGEST_CHARS} characters written in "
              f"{time.perf_counter() - t0:.1f} s [{smi}]")
        tasks = [SourceTask(name, "text", path=os.path.join(root, name)) for name, _ in facts]
        asked = facts[:: INGEST_DOCS // INGEST_QUESTIONS][:INGEST_QUESTIONS]

        # (a) the default hash provider, the index on the card, against a CPU twin
        kb = KnowledgeBase("ingest", RAGConfig(name="ingest"))
        check(kb.device.type == "cuda", f"the ingest KB is on {kb.device}")
        check(isinstance(kb.embedder, HashEmbedder) and kb.embedder._use_native
              and tokenizer_mod._USE_NATIVE, "the hash provider is not on its native path")
        reset_launches()
        with IngestTimers(kb.embedder) as timers:
            t0 = time.perf_counter()
            report = asyncio.run(kb.build_sources(tasks))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        docs = hybrid_documents(kb, asked)
        pools = dense_pools(kb, asked)
        torch.cuda.synchronize()
        counts = launch_counts()
        check(report.processed == INGEST_DOCS and report.failed == 0 and not report.errors,
              f"(a) build report {report.summary()}")
        n = report.total_chunks
        rate = n / wall
        rest = wall - sum(timers.seconds.values())
        print(f"(a) hash provider [{smi}]: {INGEST_DOCS} sources, {n} chunks "
              f"({n - INGEST_DOCS} content + {INGEST_DOCS} summary) in {wall:.2f} s wall, "
              f"{rate:.0f} chunks/s; " + "; ".join(
                  f"{k} {v:.2f} s" for k, v in timers.seconds.items())
              + f"; the rest (analysis, hashing, deletes, manifest, warm-up) {rest:.2f} s; "
              f"{timers.adds} index adds; launches {counts}")
        out["hash"] = {"chunks": n, "wall_s": wall, "chunks_per_s": rate,
                       "split_s": dict(timers.seconds, rest=rest)}
        check(counts["bfloat16"] > 0, "(a) the ingest KB's searches never launched topk_pruned")
        missing = [name for (name, _), d in zip(asked, docs) if name not in d]
        check(not missing, f"(a) facts not in their hybrid top 5: {missing}")

        t0 = time.perf_counter()
        twin = KnowledgeBase("ingest-cpu", RAGConfig(name="ingest-cpu"), device="cpu")
        ref_report = asyncio.run(twin.build_sources(tasks))
        twin_s = time.perf_counter() - t0
        ids = sorted(kb.store.index._id_to_row)
        check(ref_report.total_chunks == n and ids == sorted(twin.store.index._id_to_row),
              "(a) the CUDA and CPU builds hold different chunks")
        check(torch.equal(stored_rows(kb, ids).view(torch.int16),
                          stored_rows(twin, ids).view(torch.int16)),
              "(a) stored embeddings differ between the card and the CPU twin")
        ref_docs = hybrid_documents(twin, asked)
        ref_pools = dense_pools(twin, asked)
        check(all(name in d for (name, _), d in zip(asked, ref_docs)),
              "(a) the CPU twin misses a fact in its hybrid top 5")
        check(all(same_up_to_ties(g, r, TOL) for g, r in zip(pools, ref_pools)),
              "(a) the dense top 50 differs from the CPU twin's beyond ties within TOL")
        same = sum(d == r for d, r in zip(docs, ref_docs))
        print(f"  CPU twin [{smi}]: {ref_report.total_chunks} chunks in {twin_s:.2f} s; the same "
              f"chunk ids and bit-equal stored bf16 embeddings; {INGEST_QUESTIONS} fact "
              f"questions: each fact document in its hybrid top 5 on both, the dense top 50 the "
              f"same up to ties "
              f"within {TOL}, {same} of {INGEST_QUESTIONS} hybrid top-5 document lists identical")

        # the host paths on this build's chunk texts: Python against C
        texts = [c.content for c in kb.store.index.iter_live()][:1024]
        py_s, c_s = [], []
        for use_native, acc in ((False, py_s), (True, c_s)):
            emb = HashEmbedder(256, use_native=use_native)
            t0 = time.perf_counter()
            vecs = emb.embed_batch(texts)
            acc.append(time.perf_counter() - t0)
            acc.append(vecs)
        # the two paths sum a dimension's weights in another order
        ulps = int(np.abs(py_s[1].view(np.int32).astype(np.int64)
                          - c_s[1].view(np.int32).astype(np.int64)).max())
        diff = float(np.abs(py_s[1] - c_s[1]).max())
        check(diff <= 1e-6, f"the native hash embedder is {diff} from the Python path")
        tok = tokenizer_mod.HashTokenizer()
        batches = {}
        for use_native in (False, True):
            tokenizer_mod._USE_NATIVE = use_native
            try:
                t0 = time.perf_counter()
                batches[use_native] = (tok.batch(texts[:128]), time.perf_counter() - t0)
            finally:
                tokenizer_mod._USE_NATIVE = True
        (py_ids, py_mask), tok_py = batches[False]
        (c_ids, c_mask), tok_c = batches[True]
        check(np.array_equal(py_ids, c_ids) and np.array_equal(py_mask, c_mask),
              "the native tokenizer's ids differ from the Python path's")
        out["host"] = {"embed_py_ms": py_s[0] * 1e3, "embed_c_ms": c_s[0] * 1e3,
                       "tok_py_ms": tok_py * 1e3, "tok_c_ms": tok_c * 1e3}
        print(f"  host paths on this machine [{smi}]: HashEmbedder.embed_batch of {len(texts)} "
              f"chunks Python {py_s[0] * 1e3:.1f} ms, C {c_s[0] * 1e3:.2f} ms "
              f"({py_s[0] / c_s[0]:.0f}x; at most {ulps} ulp, {diff:.3g}, apart); "
              f"HashTokenizer.batch of 128 "
              f"chunks Python {tok_py * 1e3:.2f} ms, C {tok_c * 1e3:.2f} ms "
              f"({tok_py / tok_c:.1f}x; the same ids, T {c_ids.shape[1]})")

        # (b) incremental builds and cleanup, on the card's KB
        before = asyncio.run(kb.store.count())
        with IngestTimers(kb.embedder) as timers:
            t0 = time.perf_counter()
            again = asyncio.run(kb.build_sources(tasks))
            skip_s = time.perf_counter() - t0
        check(again.skipped == INGEST_DOCS and again.processed == 0 and timers.adds == 0
              and asyncio.run(kb.store.count()) == before,
              f"(b) unchanged sources: {again.summary()}, {timers.adds} index adds")
        rewritten = [name for name, _ in facts[1::INGEST_DOCS // INGEST_REWRITTEN]]
        write_ingest_corpus(root, seed, version=1, names=rewritten)
        t0 = time.perf_counter()
        changed = asyncio.run(kb.build_sources(tasks))
        change_s = time.perf_counter() - t0
        check(changed.processed == INGEST_REWRITTEN and changed.skipped == INGEST_DOCS
              - INGEST_REWRITTEN and changed.failed == 0, f"(b) rewrite: {changed.summary()}")
        splitter = get_splitter(kb.config.knowledge_builder.chunking)
        by_source = {r.source_id: r.chunks for r in changed.results}
        for name in rewritten:
            doc = DocumentLoaderRegistry.load(os.path.join(root, name))[0]
            want = len(splitter.split_text(doc.content, doc.metadata)) + 1  # + its summary
            got = asyncio.run(kb.store.count_by_document(name))
            check(got == want == by_source[name],
                  f"(b) {name}: {got} chunks stored, {want} expected, {by_source[name]} reported")
        cleaned = [name for name, _ in asked[:INGEST_CLEANED]]
        manager = KnowledgeCleanupManager(kb.name, kb.store, kb.tables, kb.manifest)
        for name in cleaned:
            had = asyncio.run(kb.store.count_by_document(name))
            res = asyncio.run(manager.cleanup_source(name))
            check(res["deleted_chunks"] == had > 0
                  and asyncio.run(kb.store.count_by_document(name)) == 0
                  and name not in kb.manifest.sources, f"(b) cleanup of {name}: {res}")
        after = hybrid_documents(kb, asked[:INGEST_CLEANED])
        check(all(name not in d for name, d in zip(cleaned, after)),
              "(b) a cleaned document still answers its fact question")
        print(f"(b) [{smi}] unchanged rebuild: {again.skipped} skipped, no index add, "
              f"{skip_s:.2f} s; "
              f"{INGEST_REWRITTEN} files rewritten: {changed.processed} processed, "
              f"{changed.skipped} skipped, count_by_document right for each, {change_s:.2f} s; "
              f"{INGEST_CLEANED} sources cleaned: their chunks gone, their facts no longer "
              f"answered")
        del twin

        # (c) the encoder provider over the first INGEST_ENC_DOCS files
        cfg = RAGConfig(name="ingest-enc")
        cfg.knowledge_builder.embedding = EmbeddingConfig(provider="tpu")
        enc_kb = KnowledgeBase("ingest-enc", cfg)
        emb = enc_kb.embedder
        check(isinstance(emb, TorchEmbedder) and emb.cfg == EncoderConfig(attention_impl="pallas"),
              f"(c) the encoder KB serves {type(emb).__name__} {getattr(emb, 'cfg', None)}")
        tok_s, fwd_ts, fwd_s = [0.0], [], [0.0]
        real_batch, real_fwd = emb.tokenizer.batch, embedder_mod.encode_tokens

        def timed_batch(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real_batch(*a, **kw)
            finally:
                tok_s[0] += time.perf_counter() - t0

        def timed_fwd(params, token_ids, mask, *a, **kw):
            fwd_ts.append((int(token_ids.shape[1]), int((mask.sum(1) > 0).sum())))
            t0 = time.perf_counter()
            try:
                res = real_fwd(params, token_ids, mask, *a, **kw)
                torch.cuda.synchronize()
                return res
            finally:
                fwd_s[0] += time.perf_counter() - t0

        emb.tokenizer.batch, embedder_mod.encode_tokens = timed_batch, timed_fwd
        reset_launches()
        try:
            with IngestTimers(emb) as timers:
                t0 = time.perf_counter()
                enc_report = asyncio.run(enc_kb.build_sources(tasks[:INGEST_ENC_DOCS]))
                torch.cuda.synchronize()
                enc_wall = time.perf_counter() - t0
        finally:
            del emb.tokenizer.batch
            embedder_mod.encode_tokens = real_fwd
        att = attention_counts()
        n_enc = enc_report.total_chunks
        ts = [t for t, _ in fwd_ts]
        buckets = {t: ts.count(t) for t in sorted(set(ts))}
        check(enc_report.processed == INGEST_ENC_DOCS and enc_report.failed == 0,
              f"(c) build report {enc_report.summary()}")
        n_bw = att["blockwise_attention"]
        check(n_bw > 0 and n_bw % emb.cfg.n_layers == 0 and att["flash_attention"] == 0,
              f"(c) attention launches {att}: want blockwise a positive multiple of "
              f"{emb.cfg.n_layers}, no flash")
        check(all(t == 256 for t, rows in fwd_ts if rows > 1),  # one row: the warm-up query
              f"(c) a source's chunks padded to T other than 256: {buckets}")
        embed_s = timers.seconds["embed"]
        print(f"(c) encoder provider ({emb.cfg.d_model} x {emb.cfg.n_layers} layers, seeded, "
              f"'pallas') [{smi}]: {INGEST_ENC_DOCS} sources, {n_enc} chunks in {enc_wall:.2f} s "
              f"wall, {n_enc / enc_wall:.0f} chunks/s; forwards per T {buckets} (T < 256: the "
              f"warm-up query); "
              f"embed {embed_s:.2f} s: tokenization {tok_s[0]:.3f} s, forward {fwd_s[0]:.2f} s "
              f"(to device completion), the rest {embed_s - tok_s[0] - fwd_s[0]:.3f} s; "
              f"launches {att}")
        out["encoder"] = {"chunks": n_enc, "wall_s": enc_wall, "chunks_per_s": n_enc / enc_wall,
                          "embed_s": embed_s, "tokenize_s": tok_s[0], "forward_s": fwd_s[0],
                          "buckets": buckets}
        enc_ids = sorted(enc_kb.store.index._id_to_row)[
            :: max(n_enc // INGEST_ENC_CHECKED, 1)][:INGEST_ENC_CHECKED]
        # plain attention on the host: the reference, and 2x the wrapper's
        # plain blockwise version there
        cpu_emb = TorchEmbedder(config=dataclasses.replace(emb.cfg, attention_impl="xla"),
                                params=emb.params, device="cpu")
        t0 = time.perf_counter()
        ref = cpu_emb.embed_batch([enc_kb.store.index.get_by_id(c).content for c in enc_ids])
        cpu_s = time.perf_counter() - t0
        got = stored_rows(enc_kb, enc_ids).float().numpy()[:, : emb.dimension]
        enc_err = float(np.abs(got - ref).max())
        check(np.isfinite(got).all() and enc_err <= ENC_TOL,
              f"(c) stored embeddings differ from the CPU twin's by {enc_err} > {ENC_TOL}")
        print(f"  {len(enc_ids)} stored embeddings against the CPU twin's TorchEmbedder (plain "
              f"attention, {cpu_s:.1f} s) [{smi}]: max |diff| {enc_err:.4g} (ENC_TOL {ENC_TOL})")
    out["launches"] = {"topk_pruned": counts["bfloat16"], "blockwise_attention": n_bw}
    out["errs"] = {"encoder": enc_err}
    return out


# ---------------------------------------------------------------------------
# 4g. memory and toolkits
# ---------------------------------------------------------------------------

MEM_USERS = 1024
# per user: (type, count); working memories over MEM_SESSIONS sessions
MEM_PLAN = (("working", 64), ("episodic", 96), ("semantic", 64), ("procedural", 32))
MEM_PER_USER = sum(n for _, n in MEM_PLAN)  # 256: 262,144 memories in all
MEM_SESSIONS = 4
MEM_GATE_USERS = 64
MEM_ADDS = 1024
MEM_EPOCH = 1_790_000_000.0  # the frozen clock of both stores; created_at over the 30 days before
MEM_VOCAB = 8192
META_DOCS = 64


def memory_nodes(node_cls, seed: int, n_users: int) -> tuple[list, list[str]]:
    """MEM_PER_USER memories per user, drawn from ``seed``: ids
    ``mem-u<user>-<type>-<i>``, a text of a user tag and 8-14 words of a
    shared vocabulary, importance on a 0.05 grid, created_at over the 30
    days before MEM_EPOCH, working memories over MEM_SESSIONS sessions,
    semantic ones every fourth a text2sql ``schema`` and every fourth a
    ``sql_pattern`` category, skills with use and success counts. Returns
    the nodes and their texts."""
    rng = np.random.default_rng(seed)
    vocab = np.array(sorted(set(ingest_words(rng, MEM_VOCAB))))
    nodes = []
    for u in range(n_users):
        user = f"user-{u:04d}"
        for mtype, n in MEM_PLAN:
            lens = rng.integers(8, 15, size=n)
            words = rng.choice(vocab, size=(n, 14))
            imps = np.round(rng.integers(0, 21, size=n) * 0.05, 2)
            ages = rng.uniform(0, 30 * 86400.0, size=n)
            uses = rng.integers(0, 8, size=n)
            wins = rng.integers(0, 9, size=n) % (uses + 1)
            for i in range(n):
                meta = {}
                if mtype == "semantic" and i % 4 in (1, 2):
                    meta["category"] = "schema" if i % 4 == 1 else "sql_pattern"
                elif mtype == "procedural":
                    meta["name"] = f"skill-{u}-{i}"
                node = node_cls(
                    id=f"mem-u{u:04d}-{mtype}-{i:03d}", user_id=user, memory_type=mtype,
                    content=f"u{u:04d} {mtype} " + " ".join(words[i, : lens[i]]),
                    importance=float(imps[i]), created_at=MEM_EPOCH - float(ages[i]),
                    session_id=(f"sess-{u:04d}-{i * MEM_SESSIONS // n}" if mtype == "working"
                                else ""),
                    metadata=meta)
                if mtype == "procedural":
                    node.use_count, node.success_count = int(uses[i]), int(wins[i])
                nodes.append(node)
    return nodes, [n.content for n in nodes]


def seed_memories(store, nodes: list, vecs: np.ndarray, batch: int = 32768) -> None:
    """Put ``nodes`` into a MemoryVectorStore through its store's batched
    ``add_chunks``, each row with the metadata ``MemoryVectorStore.add``
    writes (``vecs``: ``store.embedder``'s rows for the nodes' texts, as
    ``add`` embeds them one at a time)."""
    from youtu_rag_tpu_torch.core.types import Chunk

    asyncio.run(store.store.reserve(len(nodes), vecs.shape[1]))
    for b in range(0, len(nodes), batch):
        chunks = []
        for node, vec in zip(nodes[b:b + batch], vecs[b:b + batch]):
            meta = {"user_id": node.user_id, "memory_type": node.memory_type,
                    "session_id": node.session_id, "importance": node.importance,
                    "created_at": int(node.created_at)}
            if node.metadata.get("category"):
                meta["category"] = node.metadata["category"]
            chunks.append(Chunk(id=node.id, document_id=f"{node.user_id}/{node.memory_type}",
                                content=node.content, chunk_index=0, metadata=meta,
                                embedding=vec))
        asyncio.run(store.store.add_chunks(chunks))
        for node in nodes[b:b + batch]:
            store._nodes[node.id] = node


def copy_node(node):
    """A node of its own for the CPU twin (edits mutate nodes in place)."""
    import dataclasses

    return dataclasses.replace(node, metadata=dict(node.metadata))


def memory_hits(found) -> list:
    """search_memories' (node, score) pairs as same_up_to_ties reads them."""
    from types import SimpleNamespace

    return [SimpleNamespace(chunk=SimpleNamespace(id=m.id), score=float(s)) for m, s in found]


def same_lines(got: str, ref: str) -> bool:
    """Two retrieve_all_context texts: equal, or the same lines in another
    order (two memories whose scores lie within TOL may trade places)."""
    return got == ref or sorted(got.splitlines()) == sorted(ref.splitlines())


class FrozenClock:
    """One clock for the memory modules of both stores (their ``time``):
    recency is equal on the card and on its CPU twin."""

    def __init__(self, now: float):
        self.now = now

    def time(self) -> float:
        return self.now

    def strftime(self, fmt: str, *_):
        return time.strftime(fmt, time.localtime(self.now))


def memory_reads(store, tk, user: str, query: str) -> dict:
    """The gate reads of one user: search_memory's (top_k 5) hits, with
    min_importance 0.7, with a category, and retrieve_all_context."""
    return {
        "search": asyncio.run(store.search_memories(user, query, top_k=5)),
        "important": asyncio.run(store.search_memories(user, query, top_k=5,
                                                       min_importance=0.7)),
        "category": asyncio.run(store.search_memories(user, query, memory_types=["semantic"],
                                                      top_k=5, category="sql_pattern")),
        "tool": asyncio.run(tk.search_memory(query, top_k=5)),
        "context": asyncio.run(tk.retrieve_all_context(query, max_items=8)),
    }


def check_isolation(reads: dict, user: str, tag: str, what: str) -> None:
    """Tenant isolation, a hard gate: every hit the asking user's, of the
    asked types, above the asked importance, in the asked category."""
    for m, _ in reads["search"] + reads["important"]:  # search_memories' default types
        check(m.user_id == user and m.memory_type in ("episodic", "semantic", "procedural"),
              f"{what}: {user}'s search returned {m.id} of {m.user_id} ({m.memory_type})")
    check(all(m.importance >= 0.7 for m, _ in reads["important"]),
          f"{what}: a hit below min_importance 0.7 for {user}")
    check(all(m.user_id == user and m.memory_type == "semantic"
              and m.metadata.get("category") == "sql_pattern" for m, _ in reads["category"]),
          f"{what}: a hit outside {user}'s sql_pattern memories")
    lines = [ln for ln in reads["context"].splitlines() if ln.startswith("- ")]
    check(lines and all(tag in ln for ln in lines),
          f"{what}: retrieve_all_context for {user} holds another user's memory")


def memory_plane(seed: int, smi: str, part: str) -> dict:
    """4g (a): the multi-tenant memory store on the card against a CPU twin
    holding the same nodes of the gate users. Returns the launches and the
    numbers printed."""
    from youtu_rag_tpu_torch.index.device_index import _filter_bias
    from youtu_rag_tpu_torch.index.filters import compile_filter
    from youtu_rag_tpu_torch.memory import MemoryNode, MemoryVectorStore, VectorMemoryToolkit
    from youtu_rag_tpu_torch.models.embedder import HashEmbedder
    from youtu_rag_tpu_torch.ops.topk import NEG_INF, topk_pruned

    out: dict = {}
    t0 = time.perf_counter()
    n_users, gate_users = MEM_USERS, MEM_GATE_USERS
    nodes, texts = memory_nodes(MemoryNode, seed, n_users)
    emb = HashEmbedder(256)
    vecs = emb.embed_batch(texts)
    make_s = time.perf_counter() - t0
    mem = MemoryVectorStore(emb)
    check(mem.store.device.type == "cuda", f"the memory store is on {mem.store.device}")
    t0 = time.perf_counter()
    seed_memories(mem, nodes, vecs)
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    idx = mem.store.index
    # the CPU twin holds the gate users' nodes, in the card's row order:
    # every read and write below is one gate user's, and a user's filter
    # masks every other user's row, so the twin answers as one holding all
    gates = list(range(0, n_users, n_users // gate_users))[:gate_users]
    gate_ids = {f"user-{u:04d}" for u in gates}
    keep = [i for i, n in enumerate(nodes) if n.user_id in gate_ids]
    twin = MemoryVectorStore(emb, device="cpu")
    t0 = time.perf_counter()
    seed_memories(twin, [copy_node(nodes[i]) for i in keep], vecs[keep])
    twin_s = time.perf_counter() - t0
    n_mem = asyncio.run(mem.store.count())
    check(n_mem == len(nodes) and asyncio.run(twin.store.count()) == len(keep)
          == gate_users * MEM_PER_USER, f"(a) {n_mem} memories stored of {len(nodes)}")
    vec_mb = idx._vectors.numel() * idx._vectors.element_size() / 1e6
    col_mb = idx._cols.numel() * idx._cols.element_size() / 1e6
    print(f"(a) {len(nodes)} memories over {n_users} users ({MEM_PER_USER} each: "
          f"{', '.join(f'{n} {t}' for t, n in MEM_PLAN)}), texts and HashEmbedder(256) rows in "
          f"{make_s:.2f} s; one {idx._vectors.dtype} index of {tuple(idx._vectors.shape)} "
          f"({vec_mb:.1f} MB of rows, {col_mb:.1f} MB of {idx._cols.shape[1]} metadata columns, "
          f"columns {list(idx.schema.slots)}) seeded "
          f"through add_chunks in {seed_s:.2f} s on the card [{smi}]; the CPU twin, the "
          f"{gate_users} gate users' {len(keep)} memories, in {twin_s:.2f} s")
    out["seed"] = {"memories": len(nodes), "seed_s": seed_s, "twin_s": twin_s,
                   "vectors_mb": vec_mb, "columns_mb": col_mb}

    by_user: dict[str, dict[str, list]] = {}
    for n in nodes:
        by_user.setdefault(n.user_id, {}).setdefault(n.memory_type, []).append(n)
    queries = {}
    for u in gates:
        user = f"user-{u:04d}"
        words = by_user[user]["semantic"][0].content.split()
        queries[user] = " ".join(words[2:8])

    def toolkit(store, user):
        session = by_user[user]["working"][0].session_id
        return VectorMemoryToolkit({"user_id": user, "session_id": session, "store": store})

    # reads: the card (its launches counted) against the twin
    reset_launches()
    got = {user: memory_reads(mem, toolkit(mem, user), user, q) for user, q in queries.items()}
    torch.cuda.synchronize()
    launches = launch_counts()["bfloat16"]
    ref = {user: memory_reads(twin, toolkit(twin, user), user, q) for user, q in queries.items()}
    n_hits = 0
    for user, g in got.items():
        tag = f"u{user[5:]} "
        check_isolation(g, user, tag, "(a) card")
        check_isolation(ref[user], user, tag, "(a) twin")
        for key in ("search", "important", "category"):
            check(same_up_to_ties(memory_hits(g[key]), memory_hits(ref[user][key]), TOL),
                  f"(a) {user} {key}: card {memory_hits(g[key])} twin "
                  f"{memory_hits(ref[user][key])}")
            n_hits += len(g[key])
        check(same_lines(g["tool"], ref[user]["tool"]) and
              same_lines(g["context"], ref[user]["context"]),
              f"(a) {user}: search_memory / retrieve_all_context differ from the twin's:\n"
              f"{g['context']}\n--\n{ref[user]['context']}")
    check(launches > 0, "(a) the memory reads never launched topk_pruned")
    check(any(g["important"] for g in got.values()) and any(g["category"] for g in got.values()),
          "(a) the min_importance and category reads found nothing")
    print(f"  {len(gates)} users' reads (search_memory top 5, min_importance 0.7, the "
          f"sql_pattern category, retrieve_all_context 8): {n_hits} hits, every one the asking "
          f"user's and of the asked types, the same node ids as the CPU twin with scores within "
          f"{TOL} (near-ties may swap); topk_pruned launches {launches}")

    # the kernel on this index: one user's filter against no filter
    user = f"user-{gates[1]:04d}"
    filters = {"user_id": user, "memory_type": {"$in": ["episodic", "semantic"]},
               "importance": {"$gte": 0.7}}
    qv = np.asarray(emb.embed_batch([queries[user]]), np.float32)
    qpad = np.zeros((1, idx.d_pad), np.float32)
    qpad[0, : idx.dim] = qv[0] / max(float(np.linalg.norm(qv[0])), 1e-12)
    qd = torch.from_numpy(qpad).to(idx.device)
    compiled = compile_filter(filters, idx.schema)
    fbias = _filter_bias(idx._cols, idx._bias, compiled)
    k = 15  # search_memories asks the store for top_k * 3
    live = int((fbias > NEG_INF / 2).sum())
    check(0 < live <= MEM_PER_USER, f"(a) the filter keeps {live} rows")
    x = idx._vectors
    t_f = time_held_ms(lambda: topk_pruned(qd, x, fbias, k))
    t_u = time_held_ms(lambda: topk_pruned(qd, x, idx._bias, k))
    t_m = time_held_ms(lambda: _filter_bias(idx._cols, idx._bias, compiled))
    t_c = time_held_ms(lambda: torch.as_tensor(compiled.consts, device=idx.device))
    b_ms, b_by = bound("bfloat16", part, x.shape[0], x.shape[1], 1, k)
    print(f"  topk_pruned on the memory index [{smi}], q = 1, k = {k}, "
          f"{tuple(x.shape)} bf16: filtered ({live} rows live: user, $in over types, "
          f"$gte 0.7) {t_f:.4f} ms, unfiltered {t_u:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}); the filter's mask into the bias {t_m:.4f} ms, of which the copy of "
          f"its {len(compiled.consts)} constants to the card {t_c:.4f} ms (held timer: "
          f"the copy and the mask's kernels as the host enqueues them)")
    out["kernel"] = {"filtered_ms": t_f, "unfiltered_ms": t_u, "bound_ms": b_ms,
                     "mask_ms": t_m, "consts_ms": t_c, "live_rows": live}

    # host-clock medians over the gate users, on the card's store
    def median_ms(fn) -> float:
        ts = []
        for user, q in queries.items():
            t0 = time.perf_counter()
            fn(user, q)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    tks = {user: toolkit(mem, user) for user in queries}
    host = {
        "search_memory": median_ms(lambda u, q: asyncio.run(tks[u].search_memory(q, top_k=5))),
        "retrieve_all_context": median_ms(
            lambda u, q: asyncio.run(tks[u].retrieve_all_context(q, max_items=8))),
        "get_working_memory": median_ms(lambda u, q: asyncio.run(mem.get_working_memory(
            u, by_user[u]["working"][0].session_id))),
    }
    out["host_ms"] = host
    print(f"  host clock, median of {len(queries)} [{smi}]: "
          + ", ".join(f"{k_} {v:.3f} ms" for k_, v in host.items())
          + f" (get_working_memory scans all {n_mem} nodes in Python, as JAX's)")

    # writes: importance across the $gte line, a content edit, skill cleanup
    for user in queries:
        sem = by_user[user]["semantic"]
        low = next(n for n in sem if n.importance < 0.7)
        epi = by_user[user]["episodic"][0]
        stats = {}
        for name, store in (("card", mem), ("twin", twin)):
            tk = toolkit(store, user)
            before = asyncio.run(store.store.count())
            asyncio.run(tk.update_memory(low.id, importance=0.75))
            up = asyncio.run(store.search_memories(user, low.content, top_k=5, min_importance=0.7))
            asyncio.run(tk.update_memory(low.id, importance=0.6))
            down = asyncio.run(store.search_memories(user, low.content, top_k=5,
                                                     min_importance=0.7))
            new_text = f"u{user[5:]} edited {user} moved to Grindavik near the volcano"
            asyncio.run(tk.update_memory(epi.id, content=new_text))
            edited = asyncio.run(store.search_memories(user, new_text, memory_types=["episodic"],
                                                       top_k=3))
            removed = asyncio.run(store.cleanup_procedural(user))
            skills = asyncio.run(store.search_memories(user, queries[user],
                                                       memory_types=["procedural"], top_k=32))
            after = asyncio.run(store.store.count())
            check(low.id in [m.id for m, _ in up] and low.id not in [m.id for m, _ in down],
                  f"(a) {name} {user}: importance 0.75 / 0.6 did not move {low.id} across $gte")
            check(edited and edited[0][0].id == epi.id and before == after + removed,
                  f"(a) {name} {user}: the content edit ({before} -> {after} rows, {removed} "
                  f"skills removed; top {[m.id for m, _ in edited]})")
            check(all(not (m.use_count >= 3 and m.success_rate < 0.3) for m, _ in skills),
                  f"(a) {name} {user}: a failing skill is still found after cleanup")
            stats[name] = (memory_hits(up), memory_hits(down), memory_hits(edited),
                           memory_hits(skills), removed)
        (*card_hits, card_removed), (*twin_hits, twin_removed) = stats["card"], stats["twin"]
        for a, b in zip(card_hits, twin_hits):
            check(same_up_to_ties(a, b, TOL), f"(a) {user}: the writes answer unlike the twin")
        check(card_removed == twin_removed, f"(a) {user}: cleanup removed {card_removed} on "
              f"the card, {twin_removed} on the twin")
    print(f"  {len(queries)} users' writes on both: importance 0.75 then 0.6 moves a memory "
          f"across min_importance's $gte 0.7 (in place, no re-embed), a content edit keeps the "
          f"count and finds the new text first, cleanup_procedural leaves no failing skill; the "
          f"same answers as the twin")

    # save / load of one user's memories into fresh stores on the card
    user = f"user-{gates[0]:04d}"
    own = [n for n in mem._nodes.values() if n.user_id == user]
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as d:
        one = MemoryVectorStore(HashEmbedder(256))
        for n in own:
            asyncio.run(one.add(copy_node(n)))
        saved = one.save(os.path.join(d, "mem.json"))
        fresh = MemoryVectorStore(HashEmbedder(256))
        loaded = asyncio.run(fresh.load(os.path.join(d, "mem.json")))
    check(saved == loaded == len(own) and fresh.store.device.type == "cuda",
          f"(a) save/load of {user}: {saved} saved, {loaded} loaded of {len(own)}")
    # top_k such that the store's 3 x top_k candidates hold every row of the
    # asked types: two stores with other row layouts break exact ties of
    # similarity at the candidate boundary by row order, each its own way
    n_rest = MEM_PER_USER - dict(MEM_PLAN)["working"]
    for q in (queries[user], own[5].content, own[100].content):
        for kw in ({"top_k": n_rest // 3 + 1}, {"top_k": n_rest // 3 + 1, "min_importance": 0.7},
                   {"memory_types": ["working"], "top_k": dict(MEM_PLAN)["working"] // 3 + 1}):
            a = memory_hits(asyncio.run(fresh.search_memories(user, q, **kw)))
            b = memory_hits(asyncio.run(mem.search_memories(user, q, **kw)))
            check(same_up_to_ties(a, b, TOL), f"(a) the reloaded {user} answers {a}, not {b}")
    print(f"  save/load of {user}'s {saved} memories (JSON, re-embedded on load) into a fresh "
          f"store on the card: the same answers as the shared store")

    # MEM_ADDS adds, one memory per user, timed on the host clock
    rng = np.random.default_rng(seed + 1)
    extra = [MemoryNode(id=f"mem-add-{i:04d}", user_id=f"user-{i % n_users:04d}",
                        memory_type="semantic", content=f"u{i % n_users:04d} added fact "
                        + " ".join(rng.choice(texts[i].split()[2:], size=6)),
                        importance=0.5, created_at=MEM_EPOCH)
             for i in range(MEM_ADDS)]
    n_before = asyncio.run(mem.store.count())
    t0 = time.perf_counter()
    for n in extra:
        asyncio.run(mem.add(n))
    torch.cuda.synchronize()
    add_ms = (time.perf_counter() - t0) / len(extra) * 1e3
    check(asyncio.run(mem.store.count()) == n_before + len(extra),
          f"(a) {len(extra)} adds left {asyncio.run(mem.store.count())} rows of "
          f"{n_before + len(extra)}")
    out["add_ms"] = add_ms
    print(f"  {len(extra)} MemoryVectorStore.add calls (embed, one-row add_chunks, BM25): "
          f"{add_ms:.3f} ms per memory on the host clock [{smi}]")
    out["launches"] = launches
    return out


def load_config(kind: str, name: str):
    """A config through the port's ConfigLoader where the host has yaml,
    else from CONFIG_DICTS (the same configs, tests/test_torch_loader.py)."""
    import importlib.util

    from youtu_rag_tpu_torch.agents.config import AgentConfig
    from youtu_rag_tpu_torch.core.loader import ConfigLoader
    from youtu_rag_tpu_torch.tools.base import ToolkitConfig

    if importlib.util.find_spec("yaml") is not None:
        loader = ConfigLoader(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs"))
        return (loader.load_agent_config(name) if kind == "agents"
                else loader.load_toolkit_config(name))
    raw = CONFIG_DICTS[kind, name]
    model = AgentConfig if kind == "agents" else ToolkitConfig
    return model.model_validate(raw)


def check_run(rec, what: str) -> None:
    """No agent run may report an error, in itself or in a tool's output."""
    check(rec.error is None, f"{what}: the run reported {rec.error!r}")
    for t in rec.tool_calls:
        check(not t.output.startswith(("Error", "error")),
              f"{what}: tool {t.name} answered {t.output[:200]!r}")


def meta_docs(doc_cls, seed: int) -> list:
    """META_DOCS dated documents over 2019-2022 on two topics."""
    import datetime

    rng = np.random.default_rng(seed)
    topics = ("transformer attention retrieval serving", "graph neural network molecules")
    docs = []
    for i in range(META_DOCS):
        year, month = 2019 + i % 4, 1 + int(rng.integers(0, 12))
        ts = int(datetime.datetime(year, month, 15).timestamp())
        topic = topics[i % 2]
        docs.append(doc_cls(f"paper-{i:02d}", f"Paper {i} ({year}-{month:02d}) on {topic}: "
                            + " ".join(rng.choice(topic.split(), size=12)),
                            {"publish_ts": ts, "source": f"paper-{i:02d}"}))
    return docs


def memory_chat(client_cls, device):
    """memory_chat from its config through get_agent: run 1 states a fact
    (and stores it through the memory tool), a skill is stored, run 2's
    instructions must carry both."""
    from youtu_rag_tpu_torch.agents import get_agent

    cfg = load_config("agents", "memory_chat")
    turns = [client_cls.tool_response("add_memory", {
        "content": "The user's favourite colour is teal.", "memory_type": "semantic",
        "importance": 0.9}), client_cls.text_response("Noted: teal."),
        client_cls.text_response("Your favourite colour is teal.")]
    kw = {} if device is None else {"device": device}
    agent = get_agent(cfg, client=client_cls(scripted=turns), **kw)
    first = asyncio.run(agent.run("Please remember: my favourite colour is teal."))
    asyncio.run(agent.memory_toolkit.store_skill(
        "colour-recall", "For questions about the user's favourite colour", ["search_memory"]))
    second = asyncio.run(agent.run("What is my favourite colour?"))
    system = agent.client.calls[-1]["messages"][0]
    skill = next(m for m in agent.memory_toolkit.store._nodes.values()
                 if m.memory_type == "procedural")
    stores = [agent.memory_toolkit.store] + [tk.store for tk in agent.router.toolkits
                                              if hasattr(tk, "store")]
    return {"runs": (first, second), "system": system.content, "skill": skill,
            "devices": [s.store.device.type for s in stores],
            "memories": [sorted((m.memory_type, m.content) for m in s._nodes.values())
                         for s in stores]}


def meta_retrieval_agent(client_cls, device: str, seed: int):
    """The meta_retrieval config's agent over META_DOCS dated documents in a
    KB on ``device``, registered under the config's KB name: query
    analysis, a time-filtered search, scope expansion, another search,
    merge, an answer."""
    from youtu_rag_tpu_torch.agents import get_agent
    from youtu_rag_tpu_torch.core.config import RAGConfig
    from youtu_rag_tpu_torch.core.types import Document
    from youtu_rag_tpu_torch.retrieval.kb import GLOBAL_KB_REGISTRY, KnowledgeBase

    cfg = load_config("agents", "meta_retrieval")
    name = cfg.toolkits["meta_retrieval"].config["kb"]
    kb = KnowledgeBase(name, RAGConfig(name=name), device=device)
    asyncio.run(kb.build_documents(meta_docs(Document, seed)))
    GLOBAL_KB_REGISTRY.register(kb)
    f = client_cls
    turns = [f.tool_response("query_analysis", {"query": "attention papers from 2021",
                                                "session_id": "s"}),
             f.tool_response("kb_embedding_search", {"query": "transformer attention retrieval",
                                                     "top_k": 6, "session_id": "s"}),
             f.tool_response("expand_filter_scope", {"session_id": "s", "factor": 2.0}),
             f.tool_response("kb_embedding_search", {"query": "attention serving", "top_k": 6,
                                                     "session_id": "s"}),
             f.tool_response("merge_retrieval_results", {"session_id": "s", "top_k": 8}),
             f.text_response("Found the 2021 attention papers.")]
    try:
        agent = get_agent(cfg, client=client_cls(scripted=turns))
        rec = asyncio.run(agent.run("Which attention papers came out in 2021?"))
    finally:
        GLOBAL_KB_REGISTRY.remove(name)
    check(kb.device.type == device, f"(b) the meta_retrieval KB is on {kb.device}")
    return rec


def text2sql_run(tools, kb, table: str, llm, database_url: str = ""):
    """The text2sql toolkit from its config over ``kb`` (and
    ``database_url``): schema link, the SQL, and the agent's link →
    generate → execute → answer."""
    from youtu_rag_tpu_torch.tools.text2sql import Text2SQLAgent

    cfg = load_config("tools", "text2sql")
    cfg = cfg.model_copy(update={"config": {**cfg.config, "kb": kb,
                                            "database_url": database_url}})
    tk = tools.get_toolkit(cfg.name, cfg)
    link = asyncio.run(tk.schema_link("which employee has the highest salary?", top_k=2))
    sql = asyncio.run(tk.execute_sql(
        f'SELECT employee, salary FROM "{table}" ORDER BY salary DESC LIMIT 1'))
    return link, sql, asyncio.run(Text2SQLAgent(tk, llm).text2sql("who earns the most?"))


TABLE_SOURCES = ("staff.csv", "cities.csv", "prices.csv", "teams.csv")


def write_table_sources(d: str) -> tuple[str, ...]:
    """The four CSV sources of the text2sql KBs (phases 4g and 4h)."""
    import pandas as pd

    pd.DataFrame({"employee": ["alice", "bob", "carol", "dave", "erin", "frank"],
                  "department": ["eng", "eng", "sales", "sales", "hr", "eng"],
                  "salary": [120, 110, 90, 95, 80, 130]}).to_csv(f"{d}/staff.csv", index=False)
    pd.DataFrame({"city": ["paris", "rome", "oslo"], "country": ["fr", "it", "no"]}).to_csv(
        f"{d}/cities.csv", index=False)
    pd.DataFrame({"sku": ["a1", "b2"], "price": [3.5, 4.0]}).to_csv(f"{d}/prices.csv",
                                                                    index=False)
    pd.DataFrame({"team": ["eng", "sales"], "lead": ["alice", "carol"]}).to_csv(
        f"{d}/teams.csv", index=False)
    return TABLE_SOURCES


def write_external_staff(path: str, table: str) -> str:
    """A sqlite database_url's file: ``table`` with two other employees."""
    import sqlite3

    conn = sqlite3.connect(path)
    conn.execute(f'CREATE TABLE "{table}" (employee TEXT, department TEXT, salary INTEGER)')
    conn.executemany(f'INSERT INTO "{table}" VALUES (?, ?, ?)',
                     [("zed", "eng", 200), ("amy", "hr", 70)])
    conn.commit()
    conn.close()
    return path


def agent_configs(seed: int, smi: str) -> dict:
    """4g (b): memory_chat, meta_retrieval and text2sql from their configs,
    and the rag toolkit, on the card; each against a CPU twin. Returns the
    launches."""
    import importlib.util

    from youtu_rag_tpu_torch import tools
    from youtu_rag_tpu_torch.agents.llm import FakeChatClient
    from youtu_rag_tpu_torch.agents.llm_agent import LLMAgent
    from youtu_rag_tpu_torch.core.config import RAGConfig
    from youtu_rag_tpu_torch.ingest.processors import SourceTask
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase
    from youtu_rag_tpu_torch.tools.base import ToolkitConfig

    have_yaml = importlib.util.find_spec("yaml") is not None
    print(f"yaml importable on this host: {have_yaml} ("
          + ("the configs load through ConfigLoader" if have_yaml else
             "the configs are built from CONFIG_DICTS, the dicts the CPU tests hold equal to "
             "ConfigLoader's; host parsing, not the device") + ")")
    reset_launches()

    # memory_chat on the card (its stores' default device) and on the CPU
    chat = memory_chat(FakeChatClient, None)
    ref = memory_chat(FakeChatClient, "cpu")
    for r, what in ((chat, "card"), (ref, "twin")):
        for i, rec in enumerate(r["runs"]):
            check_run(rec, f"(b) memory_chat {what} run {i + 1}")
        check("## Relevant memory" in r["system"] and "favourite colour is teal" in r["system"]
              and "colour-recall" in r["system"],
              f"(b) memory_chat {what}: run 2's instructions lack the remembered fact: "
              f"{r['system'][-600:]!r}")
        check((r["skill"].use_count, r["skill"].success_count) == (1, 1),
              f"(b) memory_chat {what}: the surfaced skill's stats did not move "
              f"({r['skill'].use_count}, {r['skill'].success_count})")
    check(chat["devices"] == ["cuda", "cuda"] and ref["devices"] == ["cpu", "cpu"],
          f"(b) memory_chat stores on {chat['devices']} / {ref['devices']}")
    check(chat["memories"] == ref["memories"]
          and [r.final_output for r in chat["runs"]] == [r.final_output for r in ref["runs"]],
          "(b) memory_chat: the card's stored memories or answers differ from the twin's")
    print(f"(b) memory_chat (get_agent; stores on {chat['devices']}) [{smi}]: run 1 stored the "
          f"fact ({chat['runs'][0].tool_calls[0].output}), run 2's instructions carry "
          f"'## Relevant memory' with it and the stored skill, the skill's stats moved to "
          f"1 of 1; the same memories and answers as the CPU twin")

    # meta_retrieval over META_DOCS dated documents
    recs = {}
    for device in ("cuda", "cpu"):
        recs[device] = meta_retrieval_agent(FakeChatClient, device, seed)
        check_run(recs[device], f"(b) meta_retrieval {device}")
    searches = [t.output for t in recs["cuda"].tool_calls if t.name == "kb_embedding_search"]
    check(searches and "(2021-" in searches[0]
          and not any(f"({y}-" in searches[0] for y in (2019, 2020, 2022)),
          f"(b) meta_retrieval: the 2021 search returned {searches[0][:400]!r}")
    check([(t.name, t.arguments, t.output) for t in recs["cuda"].tool_calls]
          == [(t.name, t.arguments, t.output) for t in recs["cpu"].tool_calls],
          "(b) meta_retrieval: the card's tool outputs differ from the twin's")
    print(f"  meta_retrieval (get_agent) over {META_DOCS} dated documents: "
          f"{len(recs['cuda'].tool_calls)} tool calls, the time-filtered search returns only "
          f"2021 documents, every output the CPU twin's")

    # text2sql over a KB built from 4 CSV sources, then over a sqlite database_url
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as d:
        names = write_table_sources(d)
        drafts = [0]

        def rule(messages, tools_):
            content = messages[-1].content or ""
            if content.startswith("You translate questions"):
                drafts[0] += 1
                if drafts[0] % 2:  # a bad first draft, then the statement
                    return FakeChatClient.text_response("SELECT nope FROM missing;")
                table = next(t for t in content.split('"') if t.startswith("staff"))
                return FakeChatClient.text_response(
                    f'SELECT employee, salary FROM "{table}" ORDER BY salary DESC LIMIT 1')
            return FakeChatClient.text_response("frank earns the most (130).")

        outs = {}
        for device in ("cuda", "cpu"):
            kb = KnowledgeBase("t2s-4g", RAGConfig(name="t2s-4g"), device=device)
            report = asyncio.run(kb.build_sources([SourceTask(n, "table", path=f"{d}/{n}")
                                                   for n in names]))
            check(report.processed == len(names) and report.failed == 0,
                  f"(b) text2sql build: {report.summary()}")
            table = next(t for t in report.tables if t.startswith("staff"))
            llm = LLMAgent(client=FakeChatClient(rule_fn=rule))
            db = write_external_staff(f"{d}/ext-{device}.sqlite", table)
            outs[device] = (text2sql_run(tools, kb, table, llm),
                            text2sql_run(tools, kb, table, llm, f"sqlite:///{db}"))
    (link, sql, res), (ext_link, ext_sql, ext_res) = outs["cuda"]
    check("CREATE TABLE" in link and json.loads(sql)["rows"] == [["frank", 130]]
          and res["result"]["rows"][0][0] == "frank" and "frank" in (res["answer"] or ""),
          f"(b) text2sql over the KB's tables: {link[:200]!r} {sql} {res}")
    check(json.loads(ext_sql)["rows"][0][0] == "zed" and ext_res["result"]["rows"][0][0] == "zed"
          and table in ext_link, f"(b) text2sql over database_url: {ext_sql} {ext_res}")
    check(json.dumps(outs["cuda"], default=str) == json.dumps(outs["cpu"], default=str),
          "(b) text2sql: the card's schema link, SQL result or answer differ from the twin's")
    print(f"  text2sql (the text2sql config's toolkit) over a KB of {len(names)} CSV sources "
          f"built by build_sources: the schema link, the SQL result and the answer (a failed "
          f"draft, then the statement) equal the CPU twin's; again over a sqlite:/// "
          f"database_url")

    # the rag toolkit on a CUDA KB
    tk = tools.get_toolkit("rag", ToolkitConfig(name="rag", config={"name": "rag-4g"}))
    check(tk.kb.device.type == "cuda", f"(b) rag's KB is on {tk.kb.device}")
    built = asyncio.run(tk.rag_build(["jupiter is the largest planet", "cats are small felines",
                                      "sourdough rises with wild yeast"]))
    found = asyncio.run(tk.rag_retrieve("largest planet jupiter", top_k=1))
    cleared = asyncio.run(tk.rag_clear())
    check("3 documents" in built and "jupiter" in found and cleared == "cleared 3 chunks"
          and asyncio.run(tk.kb.store.count()) == 0, f"(b) rag: {built} / {found} / {cleared}")
    print(f"  rag on a CUDA KB: {built}; the search finds jupiter; {cleared}")
    torch.cuda.synchronize()
    launches = launch_counts()["bfloat16"]
    check(launches > 0, "(b) the agents' searches never launched topk_pruned")
    print(f"  topk_pruned launches in (b): {launches}")
    return {"launches": launches}


def memory_and_toolkits(seed: int, smi: str, part: str) -> dict:
    """4g: (a) the memory plane at a shared deployment's size, (b) agents
    from configs; both memory modules read one frozen clock throughout."""
    import youtu_rag_tpu_torch.memory.store as store_mod
    import youtu_rag_tpu_torch.memory.toolkit as toolkit_mod

    clock = FrozenClock(MEM_EPOCH)
    saved = store_mod.time, toolkit_mod.time
    store_mod.time = toolkit_mod.time = clock
    try:
        t0 = time.perf_counter()
        out = memory_plane(seed, smi, part)
        print(f"  (a) {time.perf_counter() - t0:.1f} s wall")
        t0 = time.perf_counter()
        out["agents"] = agent_configs(seed, smi)
        print(f"  (b) {time.perf_counter() - t0:.1f} s wall")
    finally:
        store_mod.time, toolkit_mod.time = saved
    out["launches"] += out["agents"]["launches"]
    return out


# ---------------------------------------------------------------------------
# 4h. agents from configs: orchestrators, environments, the trajectory store
# ---------------------------------------------------------------------------

# shipped config → (facts asked, offset into 4f's asked facts)
TEAM_KINDS = {"orchestra_example": (8, 0), "orchestrator/chain": (8, 8),
              "orchestrator/parallel": (8, 16), "workforce_example": (4, 24)}
TEAM_LOCAL = (28, 30)  # (d): the local-LLM workers' facts among 4f's asked
# 4h (e)'s timed runs per config, cut from 16 when 4h (g) and 4k came in:
# on an NVIDIA H100 80GB HBM3, 700.00 W the 16 took ~15 s of 4h's 55.3 and
# the script 968 s of its 1,200 (the phases 4h (g) and 4k add ~15 s; the
# card's host runs up to 1.32x slower on some runs). 8 keep a median and a
# spread for every config.
TEAM_TIMED_RUNS = 8
# 4h's team KB: 1,024 of 4f's files, cut from its 2,048 (the KB on the card
# and its CPU twin took 33.4 s of the script's 1,033 s on an NVIDIA H100
# 80GB HBM3, 700.00 W once 4h (g) and 4k came in); the facts asked are
# spread over the 1,024 as they were over the 2,048.
TEAM_DOCS = 1024
TEAM_KB, TEAM_TWIN = "team-kb", "team-kb-cpu"
T2S_KB, T2S_TWIN = "team-t2s", "team-t2s-cpu"
LOOK_UP = "Look up: "
COUNT_TASK = "Compute: count the facts found"
HIT_RE = re.compile(r"\[(\d+)\] \(score (-?\d+\.\d+), source ([^)]*)\)\n")


def port_agents_package(device=None) -> types.SimpleNamespace:
    """The port's agent, config, registry and trajectory-store modules as
    phase 4h drives them, with ``device`` for every agent it builds (the
    CPU tests hand the JAX package's modules to the same functions)."""
    import youtu_rag_tpu_torch.db.models as models
    import youtu_rag_tpu_torch.tracing.tracer as tracer
    from youtu_rag_tpu_torch.agents import FakeChatClient, SimpleAgent, get_agent
    from youtu_rag_tpu_torch.core.loader import ConfigLoader
    from youtu_rag_tpu_torch.db.service import DBService
    from youtu_rag_tpu_torch.retrieval.kb import GLOBAL_KB_REGISTRY

    return types.SimpleNamespace(
        get_agent=get_agent, Fake=FakeChatClient, SimpleAgent=SimpleAgent,
        loader=ConfigLoader(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")),
        registry=GLOBAL_KB_REGISTRY, DBService=DBService, models=models, tracer=tracer,
        device={"device": device})


def team_workers(cfg) -> dict:
    """The worker entries of an orchestrator's config, whatever its type."""
    return cfg.workers or cfg.orchestrator_workers or cfg.workforce_executor_agents


def team_config(pkg, kind: str, kb_name: str, database_url: str = ""):
    """The shipped config ``kind`` through the package's ConfigLoader, with
    YRT_KB_NAME (and YRT_TEXT2SQL_DB) naming this run's KB; a kb_search
    toolkit whose config names no KB (chain, parallel, workforce: it would
    look up "default") is given ``kb_name`` too."""
    saved = {k: os.environ.get(k) for k in ("YRT_KB_NAME", "YRT_TEXT2SQL_DB")}
    os.environ["YRT_KB_NAME"], os.environ["YRT_TEXT2SQL_DB"] = kb_name, database_url
    try:
        cfg = pkg.loader.load_agent_config(kind)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for w_cfg in team_workers(cfg).values():
        tk = w_cfg.toolkits.get("kb_search")
        if tk is not None and "kb" not in tk.config:
            tk.config["kb"] = kb_name
    return cfg


def subtask(text: str) -> str:
    """A worker's own subtask, past the context its orchestrator puts first."""
    for marker in ("Your subtask: ", "Your task: ", "\nTask: "):
        at = text.rfind(marker)
        if at >= 0:
            return text[at + len(marker):].strip()
    return text.strip()


def team_planner(fake, questions: list[str], count: bool = True, prefix: str = LOOK_UP):
    """The scripted planner, router, assigner, checker, merger, answerer and
    reporter of every orchestrator type: one searcher subtask per question,
    then a count (orchestra's analyst, workforce's coder) or a summary
    (chain's and parallel's writer; orchestra's count only with ``count``);
    each answer counts the facts found. Subtasks read ``prefix`` + question
    (the scripted workers look for LOOK_UP; a local model is asked the bare
    question, the form it was trained on)."""
    look = [prefix + q for q in questions]

    def found(text: str) -> str:
        return f"{text.count(': found')} of {len(look)} facts found."

    def rule(messages, tools):
        system, content = messages[0].content or "", messages[-1].content or ""
        if "task planner" in system:
            plan = [{"agent_name": "searcher", "task": t, "completed": False} for t in look]
            if count:
                plan.append({"agent_name": "analyst", "task": COUNT_TASK, "completed": False})
            return fake.text_response("<analysis>one search per question, then a count"
                                      "</analysis>\n<plan>[\n"
                                      + ",\n".join(json.dumps(t) for t in plan) + "\n]</plan>")
        if "Trajectory:" in content:
            return fake.text_response("Report: " + found(content))
        searches = [{"agent_name": "searcher", "task": t} for t in look]
        writer = {"agent_name": "writer", "task": "Write the summary"}
        if "orchestrator routing" in system:
            return fake.text_response(json.dumps(searches + [writer]))
        if "INDEPENDENT" in system:
            return fake.text_response(json.dumps({"groups": [searches, [writer]]}))
        if content.startswith("Merge the results"):
            return fake.text_response("Merged: " + found(content))
        if "project planner" in system:
            return fake.text_response(json.dumps(look + [COUNT_TASK]))
        if content.startswith("Pick the best executor"):
            task = content.split("\nTask: ", 1)[1].split("\n\nReply JSON only", 1)[0]
            name = "researcher" if task.startswith(LOOK_UP) else "coder"
            return fake.text_response(json.dumps({"executor": name, "instruction": task}))
        if content.startswith("You are reviewing plan progress"):
            return fake.text_response('{"action": "continue"}')
        if content.startswith("Extract the final answer"):
            return fake.text_response("Answer: " + found(content))
        return fake.text_response("(unscripted)")

    return rule


def team_worker(fake, docs: dict[str, str]):
    """A worker's scripted model: a subtask that names a question gets one
    kb_hybrid_search of it, then whether the question's document came
    back; the count gets one python run over the results in its context;
    anything else a summary of them."""

    def rule(messages, tools):
        task = subtask(next((m.content for m in messages if m.role == "user"), "") or "")
        context = next((m.content for m in messages if m.role == "user"), "") or ""
        question = task[len(LOOK_UP):] if task.startswith(LOOK_UP) else None
        last = messages[-1]
        if last.role == "tool":
            if question is not None:
                doc = docs[question]
                return fake.text_response(f"{doc}: {'found' if doc in last.content else 'missing'}")
            return fake.text_response(f"Computed: {last.content.strip()} facts found.")
        if question is not None:
            return fake.tool_response("kb_hybrid_search", {"query": question, "top_k": 5})
        if task == COUNT_TASK:
            return fake.tool_response("execute_python_code",
                                      {"code": f"print({context.count(': found')})"})
        return fake.text_response(f"Summary: {context.count(': found')} facts found.")

    return rule


def record_worker_runs(workers: dict, runs: dict) -> None:
    """Tee every run of each worker into ``runs[name]``: (task, recorder,
    the events it emitted). The orchestrators forward a worker's events
    only in parallel; text2sql's worker emits none."""
    for name, w in workers.items():
        log = runs.setdefault(name, [])
        if hasattr(w, "run_streamed"):
            def run_streamed(task, _real=w.run_streamed, _log=log, **kw):
                rec = _real(task, **kw)
                events, emit = [], rec.emit

                def tee(ev, _events=events, _emit=emit):
                    _events.append(ev)
                    _emit(ev)

                rec.emit = tee
                _log.append((task, rec, events))
                return rec

            w.run_streamed = run_streamed
        else:
            async def run(task, _real=w.run, _log=log):
                rec = await _real(task)
                _log.append((task, rec, []))
                return rec

            w.run = run


def event_view(e) -> tuple:
    """An event without its timestamp (and a task card's duration_ms)."""
    data = {k: v for k, v in e.data.items() if k != "duration_ms"}
    return (e.type, e.text, e.name, e.arguments, e.call_id, json.dumps(data, sort_keys=True))


def event_key(e) -> str:
    """The stream an event belongs to: a parallel task's (its worker, group
    and index) or the orchestrator's own; concurrent tasks interleave."""
    d = e.data
    return f"{d.get('parallel_agent') or d.get('agent_name') or ''}/{d.get('group', '')}/" \
           f"{d.get('task_idx', '')}"


def record_rows(db, cls, trace_id: str, drop: tuple) -> list[dict]:
    import dataclasses

    rows = db.select(cls, where={"trace_id": trace_id}, limit=100_000, order_by="_rowid ASC")
    return sorted((json.dumps({k: v for k, v in dataclasses.asdict(r).items() if k not in drop},
                              sort_keys=True) for r in rows))


def drive_team_run(pkg, agent, agent_type: str, task: str, kbs: list, db,
                   docs: dict[str, str]) -> dict:
    """One orchestrator run, streamed, with ``kbs`` registered under their
    names for it (the registry as it was after), its trajectory written
    through a sink into ``db`` and its spans recorded by
    ``setup_tracing(db_service=db)``. Returns what the gates and the twin
    comparison read."""
    import dataclasses
    import uuid

    saved = {kb.name: pkg.registry.get(kb.name) for kb in kbs}
    for kb in kbs:
        pkg.registry.register(kb)
    models = pkg.models
    trace_id = f"4h-{uuid.uuid4().hex[:12]}"

    async def sink(record):
        db.add(models.TrajectoryRecord.from_recorder_dict(record, agent_type=agent_type))

    async def go():
        with pkg.tracer.get_tracer().trace(trace_id):
            rec = agent.run_streamed(task)
            events = [e async for e in rec.stream_events()]
            try:
                await rec.wait()
            except RuntimeError:
                pass  # rec.error says why
            await sink(rec.as_record())
        return rec, events

    runs: dict = {}
    before = db.count(models.TrajectoryRecord)
    try:
        asyncio.run(agent.build())
        record_worker_runs(getattr(agent, "_workers", None) or getattr(agent, "_executors", None)
                           or {}, runs)
        pkg.tracer.setup_tracing(db_service=db)
        t0 = time.perf_counter()
        rec, events = asyncio.run(go())
        seconds = time.perf_counter() - t0
    finally:
        pkg.tracer.setup_tracing()
        for name, prev in saved.items():
            if prev is None:
                pkg.registry.remove(name)
            else:
                pkg.registry.register(prev)
        asyncio.run(agent.cleanup())
    grouped: dict[str, list] = {}
    for e in events:
        grouped.setdefault(event_key(e), []).append(event_view(e))
    workers, observations, searches, errors = {}, [], 0, []
    for name, log in runs.items():
        views = []
        for sub, wrec, evs in log:
            calls = [(t.name, t.arguments, t.output) for t in wrec.tool_calls]
            views.append((sub, [event_view(e) for e in evs], wrec.trajectory, calls,
                          wrec.final_output, wrec.error))
            errors += [f"{name}: {wrec.error}"] if wrec.error else []
            if agent_type == "orchestra_react_sql":
                searches += 1  # the text2sql worker's schema-linking search
            for tname, args, out in calls:
                if tname.startswith("kb_"):
                    searches += 1
                    try:
                        doc = docs.get(json.loads(args).get("query"))
                    except (json.JSONDecodeError, AttributeError):
                        doc = None
                    if doc is not None:
                        observations.append((doc, out))
        workers[name] = sorted(views, key=lambda v: v[0])
    trajectory = rec.trajectory
    if agent_type == "parallel_orchestrator":  # workers finish in any order
        trajectory = sorted(trajectory, key=lambda t: json.dumps(t, sort_keys=True))
    newest = db.select(models.TrajectoryRecord, limit=1)
    record = {}
    if newest:
        record = {k: v for k, v in dataclasses.asdict(newest[0]).items()
                  if k not in ("trace_id", "created_at")}
        record["tool_calls"] = [{k: v for k, v in t.items() if k != "duration_ms"}
                                for t in record["tool_calls"]]
    ids = ("trace_id", "span_id", "created_at", "duration_ms")
    return {
        "error": rec.error, "worker_errors": errors, "final": rec.final_output,
        "trajectory": trajectory, "events": grouped, "workers": workers,
        "observations": observations, "searches": searches,
        "missing": [doc for doc, out in observations if doc not in out],
        "records_added": db.count(models.TrajectoryRecord) - before,
        "record": record,
        "tools": record_rows(db, models.ToolTraceRecord, trace_id, ids),
        "generations": record_rows(db, models.GenerationTraceRecord, trace_id, ids),
        "seconds": seconds,
    }


def scripted_run(pkg, kind: str, kb, facts: list[tuple[str, str]], db) -> dict:
    """The shipped config ``kind`` through ``get_agent`` with a scripted
    planner, its workers built from the config's worker entries with
    ``team_worker`` models, over ``kb``: one subtask per (document,
    question) of ``facts``."""
    cfg = team_config(pkg, kind, kb.name)
    docs = {q: name for name, q in facts}
    workers = {name: pkg.SimpleAgent(w_cfg, client=pkg.Fake(rule_fn=team_worker(pkg.Fake, docs)),
                                     **pkg.device)
               for name, w_cfg in team_workers(cfg).items()}
    key = "executors" if cfg.type == "workforce" else "workers"
    agent = pkg.get_agent(cfg, client=pkg.Fake(rule_fn=team_planner(pkg.Fake, list(docs))),
                          **{key: workers}, **pkg.device)
    task = "Answer from the knowledge base: " + " ".join(docs)
    return drive_team_run(pkg, agent, cfg.type, task, [kb], db, docs)


T2S_QUESTION = "Which employee earns the most?"


def text2sql_team_run(pkg, kb, database_url: str, db) -> dict:
    """``examples/text2sql`` through ``get_agent`` (the factory builds its
    text2sql worker) with one scripted model for the planner, the SQL
    drafts (a failing one first), the answer and the report, over ``kb``'s
    tables and the ``database_url`` its config reads."""
    cfg = team_config(pkg, "examples/text2sql", kb.name, database_url)
    fake, drafts = pkg.Fake, [0]

    def rule(messages, tools):
        system, content = messages[0].content or "", messages[-1].content or ""
        if "task planner" in system:
            plan = {"agent_name": "text2sql", "task": T2S_QUESTION, "completed": False}
            return fake.text_response(f"<analysis>one query</analysis><plan>[{json.dumps(plan)}]"
                                      "</plan>")
        if content.startswith("You translate questions"):
            drafts[0] += 1
            if drafts[0] % 2:
                return fake.text_response("SELECT nope FROM missing;")
            table = next(t for t in content.split('"') if t.startswith("staff"))
            return fake.text_response(
                f'SELECT employee, salary FROM "{table}" ORDER BY salary DESC LIMIT 1')
        if "Trajectory:" in content:
            return fake.text_response("Report: zed earns the most (200).")
        return fake.text_response("zed earns the most (200).")

    agent = pkg.get_agent(cfg, client=fake(rule_fn=rule), **pkg.device)
    return drive_team_run(pkg, agent, cfg.type, T2S_QUESTION, [kb], db, {})


def parse_hits(text: str) -> list[tuple[float, str, str]] | None:
    """(score, source, content) of each hit of a KB search observation
    (``tools/kb_search.py``'s format), or None for other text."""
    parts = HIT_RE.split(text)
    if len(parts) < 5 or parts[0]:
        return None
    return [(float(parts[i + 1]), parts[i + 2], parts[i + 3].strip("\n"))
            for i in range(1, len(parts), 4)]


def same_observation(got: str, ref: str, tol: float = TOL + 1e-3) -> bool:
    """Two KB search observations that list the same hits with printed
    scores within ``tol`` (three decimals), except that hits whose scores
    lie within ``tol`` of each other may trade places (the card sums in
    another order than the CPU) and the last may be the one ranked next."""
    if got == ref:
        return True
    g, r = parse_hits(got), parse_hits(ref)
    if g is None or r is None or len(g) != len(r):
        return False
    ref_score = {(src, body): s for s, src, body in r}
    for i, ((gs, gsrc, gbody), (rs, rsrc, rbody)) in enumerate(zip(g, r)):
        if abs(gs - rs) > tol:
            return False
        if (gsrc, gbody) != (rsrc, rbody):
            other = ref_score.get((gsrc, gbody))
            if (other is None and i != len(r) - 1) or (other is not None
                                                       and abs(other - rs) > tol):
                return False
    return True


def compare_runs(got: dict, want: dict) -> tuple[list[str], int]:
    """Where run ``got`` differs from ``want``: the final output, the
    orchestrator's trajectory and per-stream events, each worker's runs
    (events, trajectory, tool calls, output), the trajectory record and the
    trace rows. A KB search's observation may differ only as
    ``same_observation`` allows; its truncated copies (events 4,000,
    trajectories 2,000, trace rows 500 characters) then read as the
    reference's. Returns one line per difference, and how many observations
    differed by near-ties."""
    subst: dict[str, str] = {}
    ties = 0
    for name, runs in want["workers"].items():
        for g, w in zip(got["workers"].get(name, []), runs):
            for (gn, ga, go), (wn, wa, wo) in zip(g[3], w[3]):
                if go != wo and (gn, ga) == (wn, wa) and same_observation(go, wo):
                    subst.update({go[:n]: wo[:n] for n in (500, 2000, 4000)})
                    subst[go] = wo
                    ties += 1

    def canon(v):
        if isinstance(v, str):
            if v in subst:
                return subst[v]
            if v.startswith("{"):  # a trace row: its output field
                try:
                    row = json.loads(v)
                except json.JSONDecodeError:
                    return v
                if isinstance(row, dict) and row.get("output") in subst:
                    return json.dumps({**row, "output": subst[row["output"]]}, sort_keys=True)
            return v
        if isinstance(v, (list, tuple)):
            return type(v)(canon(x) for x in v)
        if isinstance(v, dict):
            return {k: canon(x) for k, x in v.items()}
        return v

    diffs = []
    for key in ("error", "worker_errors", "final", "trajectory", "events", "workers",
                "searches", "missing", "records_added", "record", "tools", "generations"):
        mine = canon(got[key])
        if key in ("tools", "generations"):
            mine = sorted(mine)
        if mine != want[key]:
            diffs.append(f"{key}: {str(mine)[:300]} != {str(want[key])[:300]}")
    return diffs, ties


def spread(xs: list[float]) -> str:
    return (f"median {statistics.median(xs) * 1e3:.1f} ms (min {min(xs) * 1e3:.1f}, "
            f"max {max(xs) * 1e3:.1f})")


def topk_device_ms(fn) -> tuple[float, float]:
    """(topk_pruned's kernels, every kernel) device ms of one call of ``fn``
    (torch.profiler)."""
    kernels = device_kernels(fn, 1)
    scan = sum(us for name, (_, us) in kernels.items() if "topk_" in name)
    return scan / 1e3, sum(us for _, us in kernels.values()) / 1e3


def team_agents(seed: int, smi: str) -> dict:
    """4h: the shipped orchestrator configs on a team's KB (TEAM_DOCS of 4f's
    files) on the card against a CPU twin, the trajectory store, the
    environments, local-LLM workers built from config, and timings.
    Returns the main path's topk_pruned launches ((a) and (d))."""
    from youtu_rag_tpu_torch.agents.env import BrowserEnv
    from youtu_rag_tpu_torch.agents.local_llm import LocalChatClient
    from youtu_rag_tpu_torch.core.config import RAGConfig
    from youtu_rag_tpu_torch.ingest.processors import SourceTask
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase
    from youtu_rag_tpu_torch.retrieval.monitoring import StorageMonitor

    card, twin = port_agents_package(None), port_agents_package("cpu")
    launches = 0
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        facts = write_ingest_corpus(root, seed, names=[f"doc{i:04d}.md"
                                                       for i in range(TEAM_DOCS)])[:TEAM_DOCS]
        asked = facts[:: TEAM_DOCS // INGEST_QUESTIONS][:INGEST_QUESTIONS]
        tasks = [SourceTask(name, "text", path=os.path.join(root, name)) for name, _ in facts]
        t0 = time.perf_counter()
        kb = KnowledgeBase(TEAM_KB, RAGConfig(name=TEAM_KB))
        report = asyncio.run(kb.build_sources(tasks))
        twin_kb = KnowledgeBase(TEAM_TWIN, RAGConfig(name=TEAM_TWIN), device="cpu")
        twin_report = asyncio.run(twin_kb.build_sources(tasks))
        check(report.processed == TEAM_DOCS and report.failed == 0 and kb.device.type == "cuda"
              and twin_report.total_chunks == report.total_chunks,
              f"the team KB: {report.summary()} / twin {twin_report.summary()}")
        names = write_table_sources(root)
        t2s = {}
        for device, name in ((None, T2S_KB), ("cpu", T2S_TWIN)):
            t2s_kb = KnowledgeBase(name, RAGConfig(name=name), device=device)
            rep = asyncio.run(t2s_kb.build_sources([SourceTask(n, "table", path=f"{root}/{n}")
                                                    for n in names]))
            check(rep.processed == len(names) and rep.failed == 0, f"text2sql KB {rep.summary()}")
            table = next(t for t in rep.tables if t.startswith("staff"))
            t2s[device] = (t2s_kb, "sqlite:///" + write_external_staff(
                f"{root}/ext-{name}.sqlite", table))
        print(f"team KB {TEAM_KB!r} on the card and {TEAM_TWIN!r} on the CPU: {TEAM_DOCS} "
              f"files, {report.total_chunks} chunks each, built in {time.perf_counter() - t0:.1f} s; "
              f"text2sql KBs of {len(names)} CSV sources with a sqlite database_url [{smi}]")
        card_db = card.DBService(f"sqlite:///{root}/card.db")
        twin_db = twin.DBService(f"sqlite:///{root}/twin.db")

        # (a) and (b): each shipped config against its CPU twin, through the trajectory store
        runs = [(kind, asked[at:at + n]) for kind, (n, at) in TEAM_KINDS.items()]
        for kind, chosen in runs + [("examples/text2sql", [])]:
            reset_launches()
            if chosen:
                got = scripted_run(card, kind, kb, chosen, card_db)
            else:
                got = text2sql_team_run(card, *t2s[None], card_db)
            torch.cuda.synchronize()
            n = launch_counts()["bfloat16"]
            launches += n
            want = (scripted_run(twin, kind, twin_kb, chosen, twin_db) if chosen
                    else text2sql_team_run(twin, *t2s["cpu"], twin_db))
            for side, run in (("card", got), ("twin", want)):
                check(run["error"] is None and not run["worker_errors"],
                      f"(a) {kind} {side}: {run['error']} {run['worker_errors']}")
                check(not run["missing"], f"(a) {kind} {side}: documents missing from their "
                      f"workers' observations: {run['missing']}")
                check(run["records_added"] == 1, f"(b) {kind} {side}: {run['records_added']} "
                      "trajectory records for one run")
            diffs, ties = compare_runs(got, want)
            check(not diffs, f"(a) {kind}: the card's run differs from the CPU twin's: {diffs}")
            check(n >= got["searches"] > 0,
                  f"(a) {kind}: {n} topk_pruned launches for {got['searches']} searches")
            if not chosen:
                sql = got["workers"]["text2sql"][0][3][0]
                check(json.loads(sql[2])["rows"][0][0] == "zed" and "zed" in got["final"],
                      f"(a) text2sql: {sql} -> {got['final']!r}")
            print(f"(a) {kind} [{smi}]: {len(chosen) or 1} question(s), {got['searches']} worker "
                  f"searches, {n} topk_pruned launches, {got['seconds'] * 1e3:.1f} ms; final "
                  f"{got['final']!r}; output, events per stream, worker runs and trajectory equal "
                  f"to the CPU twin's ({ties} observation(s) up to near-ties); (b) 1 trajectory "
                  f"record, {len(got['tools'])} tool and {len(got['generations'])} generation "
                  f"trace rows, equal to the twin's")

        # (c) environments
        from youtu_rag_tpu_torch.agents import AgentConfig, FakeChatClient, SimpleAgent

        f = FakeChatClient
        agent = SimpleAgent(AgentConfig.from_dict({"env": {"name": "shell_local"}}), client=f(
            scripted=[f.tool_response("run_bash", {"command": "echo 4h > note.txt && cat note.txt"}),
                      f.tool_response("execute_python_code",
                                      {"code": "print(open('note.txt').read().strip() * 2)"}),
                      f.text_response("done")]))
        rec = asyncio.run(agent.run("write a note"))
        ws = agent.env.workspace
        outs = [t.output for t in rec.tool_calls]
        check(rec.error is None and outs == ["4h", "4h4h"] and os.path.exists(ws),
              f"(c) shell_local: {rec.error} {outs}")
        asyncio.run(agent.cleanup())
        check(not os.path.exists(ws), f"(c) shell_local left its workspace {ws}")
        browser = BrowserEnv()
        try:
            asyncio.run(browser.build())
            state = f"built: {browser.get_state()}"
            asyncio.run(browser.cleanup())
        except RuntimeError as e:
            state = f"not built: {e}"
        print(f"(c) shell_local: run_bash and execute_python_code in its workspace, gone after "
              f"cleanup; BrowserEnv {state}")

        # (d) orchestra_example with local-LLM workers the orchestrator builds from config
        chosen = asked[TEAM_LOCAL[0]:TEAM_LOCAL[1]]
        local = {"provider": "local", "weights_dir": CHAT_WEIGHTS}
        transcripts = {}
        for pkg, side_kb in ((card, kb), (twin, twin_kb)):
            cfg = team_config(pkg, "orchestra_example", side_kb.name)
            for w_cfg in team_workers(cfg).values():
                w_cfg.model = w_cfg.model.model_validate(local)
            docs = {q: name for name, q in chosen}
            agent = pkg.get_agent(cfg, client=pkg.Fake(
                rule_fn=team_planner(pkg.Fake, list(docs), count=False, prefix="")), **pkg.device)
            reset_launches()
            run = drive_team_run(pkg, agent, cfg.type, " ".join(docs), [side_kb],
                                 card_db if pkg is card else twin_db, docs)
            if pkg is card:
                torch.cuda.synchronize()
                launches += launch_counts()["bfloat16"]
                clients = [w.client.inner for w in agent._workers.values()]
                check(all(isinstance(c, LocalChatClient) and c.device.type == "cuda"
                          for c in clients), f"(d) worker clients {clients}")
            check(run["error"] is None and not run["worker_errors"],
                  f"(d) {'card' if pkg is card else 'CPU'}: {run['error']} {run['worker_errors']}")
            transcripts[pkg is card] = run
        for (name, runs_), (_, cpu_runs) in zip(transcripts[True]["workers"].items(),
                                                transcripts[False]["workers"].items()):
            for r, c in zip(runs_, cpu_runs):
                print(f"  (d) {name} on the card: {[(t[0], t[1]) for t in r[3]]} -> {r[4]!r}\n"
                      f"      on the CPU:  {[(t[0], t[1]) for t in c[3]]} -> {c[4]!r}")
        print(f"(d) orchestra_example, workers built from config as LocalChatClient on cuda "
              f"(yrt_tiny_chat, bf16): no error; final {transcripts[True]['final']!r}; "
              f"transcripts equal to the CPU port's: "
              f"{transcripts[True]['workers'] == transcripts[False]['workers']}")

        # (e) timings on the host clock, the card's searches inside
        for kind, chosen in runs + [("examples/text2sql", [])]:
            secs, counts = [], []
            for _ in range(TEAM_TIMED_RUNS):
                reset_launches()
                run = (scripted_run(card, kind, kb, chosen, card_db) if chosen
                       else text2sql_team_run(card, *t2s[None], card_db))
                torch.cuda.synchronize()
                check(run["error"] is None, f"(e) {kind}: {run['error']}")
                secs.append(run["seconds"])
                counts.append(launch_counts()["bfloat16"])
            scan_ms, all_ms = topk_device_ms(
                lambda: scripted_run(card, kind, kb, chosen, card_db) if chosen
                else text2sql_team_run(card, *t2s[None], card_db))
            print(f"(e) {kind} [{smi}]: {TEAM_TIMED_RUNS} runs, {spread(secs)} on the host clock; "
                  f"topk_pruned launches per run {sorted(set(counts))}, its kernels "
                  f"{scan_ms:.4f} ms of {all_ms:.4f} ms device time per run")
        parallel = dict(runs)["orchestrator/parallel"]
        by_window = {}
        for window in (0.0, 2.0):
            kb.store.config.coalesce_window_ms = window
            reset_launches()
            by_window[window] = scripted_run(card, "orchestrator/parallel", kb, parallel, card_db)
            torch.cuda.synchronize()
            by_window[window]["launches"] = launch_counts()["bfloat16"]
        kb.store.config.coalesce_window_ms = 0.0
        diffs, ties = compare_runs(by_window[2.0], by_window[0.0])
        check(not diffs, f"(e) parallel with coalesce_window_ms 2 differs from 0: {diffs}")
        stats = kb.store._search_coalescer.stats if kb.store._search_coalescer else {}
        print(f"(e) orchestrator/parallel at max_parallel 4 [{smi}]: coalesce_window_ms 0: "
              f"{by_window[0.0]['launches']} launches, {by_window[0.0]['seconds'] * 1e3:.1f} ms; "
              f"2: {by_window[2.0]['launches']} launches, {by_window[2.0]['seconds'] * 1e3:.1f} ms "
              f"(coalescer {stats}); the same results ({ties} up to near-ties)")
        monitor = StorageMonitor(kb.store, name=TEAM_KB)
        health = asyncio.run(monitor.check_health())
        check(health.is_healthy and health.total_chunks == report.total_chunks
              and health.backend == "torch",
              f"(e) StorageMonitor.check_health: {health}")
        metric_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            metrics = asyncio.run(monitor.collect_metrics())
            metric_s.append(time.perf_counter() - t0)
        print(f"(e) StorageMonitor on the card's store [{smi}]: healthy, {health.total_chunks} "
              f"chunks, index {health.index_size_bytes} bytes; collect_metrics {spread(metric_s)} "
              f"(BM25 {metrics['lexical_index']})")
        print(f"  topk_pruned launches in (a) and (d): {launches}")
        db_commands(card_db, os.path.join(root, "card.db"))
        card_db.close()
        twin_db.close()
    return {"launches": launches}


def command(module: str, *args: str) -> str:
    """The standard output of ``python -m <module> <args>`` run from the
    checkout; fails the phase on a non-zero exit."""
    out = subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
    check(out.returncode == 0, f"{module} {' '.join(args)}: exit {out.returncode}: "
          f"{out.stderr[-2000:]}")
    return out.stdout


def db_commands(db, path: str) -> None:
    """4h (g): the operator commands over the card's trajectory DB, each
    held against what ``db`` (its DBService) reads."""
    import shutil

    from youtu_rag_tpu_torch.db.models import (EvaluationSample, GenerationTraceRecord,
                                               ToolTraceRecord, TrajectoryRecord)
    from youtu_rag_tpu_torch.db.service import DBService
    from youtu_rag_tpu_torch.db_dump import TABLES

    t0 = time.perf_counter()
    url = f"sqlite:///{path}"
    dump = command("youtu_rag_tpu_torch.db_dump", "--db", url)
    header = re.compile(r"== (\w+) \((\d+) total, showing (\d+)\) ==")
    shown, name = {}, None
    for line in dump.splitlines():
        m = header.fullmatch(line)
        if m:
            name = m.group(1)
            shown[name] = [int(m.group(2)), int(m.group(3)), 0]
        else:
            check(name is not None and line.startswith("{"), f"(g) db_dump line {line[:80]!r}")
            shown[name][2] += 1
    counts = {name: db.count(cls) for name, cls in TABLES.items()}
    check(list(shown) == list(TABLES) and all(
        shown[n] == [c, min(50, c), min(50, c)] for n, c in counts.items()),
        f"(g) db_dump's (total, shown, rows) {shown} for the DB's counts {counts}")

    tool = "kb_hybrid_search"  # the tool 4h's scripted workers call
    lines = [json.loads(x) for x in command("youtu_rag_tpu_torch.trace_search", "--db", url,
                                            "--name", tool).splitlines()]
    tools = [x for x in lines if x["kind"] == "tool"]
    gens = lines[len(tools):]
    n_tool = db.count(ToolTraceRecord, {"name": tool})
    n_gen = db.count(GenerationTraceRecord)
    check(n_tool > 0 and all(x["name"] == tool for x in tools)
          and len(tools) == min(30, n_tool) and len(gens) == min(30, n_gen)
          and all(x["kind"] == "generation" for x in gens),
          f"(g) trace_search --name {tool}: {len(tools)} tool and {len(gens)} generation lines "
          f"for {n_tool} and {n_gen} rows")

    report = json.loads(command("youtu_rag_tpu_torch.analysis.tool_usage", "--db", url, "--json"))
    runs = db.select(TrajectoryRecord, limit=1000)
    per_tool: dict[str, int] = {}
    for r in runs:
        for c in r.tool_calls or []:
            per_tool[c.get("name", "?")] = per_tool.get(c.get("name", "?"), 0) + 1
    spans: dict[str, int] = {}
    for r in db.select(ToolTraceRecord, limit=10_000):
        spans[r.name] = spans.get(r.name, 0) + 1
    got = report["trajectories"]
    latency = {name: v["calls"] for name, v in report["tool_latency"].items()}
    check(got["runs"] == len(runs) == counts["trajectories"] and got["calls_per_tool"] == per_tool
          and latency == spans and sum(spans.values()) == counts["tool_traces"],
          f"(g) tool_usage: {got['runs']} runs, {got['calls_per_tool']}, spans {latency}; the DB: "
          f"{len(runs)} runs, {per_tool}, spans {spans}")

    copy = path + ".copy"
    shutil.copy(path, copy)
    side = DBService(f"sqlite:///{copy}")
    for i in range(8):
        side.add(EvaluationSample(dataset="4h", index=i, raw_question=f"q{i}"))
    side.close()
    cleared = command("youtu_rag_tpu_torch.db_dump", "--db", f"sqlite:///{copy}", "--clear",
                      "evaluation_samples")
    side = DBService(f"sqlite:///{copy}")
    left = {name: side.count(cls) for name, cls in TABLES.items()}
    side.close()
    n_clear = counts["evaluation_samples"] + 8
    check(cleared.strip() == f"cleared {n_clear} rows from evaluation_samples"
          and left == {**counts, "evaluation_samples": 0},
          f"(g) --clear evaluation_samples: {cleared.strip()!r}, rows left {left}, before {counts}")
    print(f"(g) db_dump (a subprocess): {counts} rows, each table's count and min(50, count) "
          f"rows; trace_search --name {tool}: {len(tools)} tool lines of {n_tool} rows and "
          f"{len(gens)} generation lines; tool_usage --json: {got['runs']} runs, calls per tool "
          f"{got['calls_per_tool']}, spans per tool {latency}, as the DB counts; --clear "
          f"evaluation_samples on a copy given 8 samples: {n_clear} cleared, the rest as it "
          f"was; {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 4i. the API on the card
# ---------------------------------------------------------------------------

API_DOCS = 512  # of 4f's corpus
API_QUESTIONS = 64
API_RESTORED = 8
API_MEMORIES = 256
API_MEMORY_QUERIES = 16
API_PROFILED = 16


def api_build(state, root: str, names: list[str]):
    """What ``POST /api/files/upload`` and ``POST .../build {"files": ...}``
    do: each file into the state's file store, then one staged build of
    them into the KB "api" (created on the state's device)."""
    from youtu_rag_tpu_torch.ingest.processors import SourceTask

    for name in names:
        with open(os.path.join(root, name), "rb") as f:
            state.files.upload("uploads", name, f.read(), {})
    kb = state.get_or_create_kb("api")
    tasks = [SourceTask(name, "text", path=str(state.files.local_path("uploads", name)),
                        metadata=dict(state.files.stat("uploads", name)["user_metadata"]))
             for name in names]
    return kb, asyncio.run(kb.build_sources(tasks))


def api_on_card(seed: int, smi: str) -> dict:
    """4i: the API on the card. Its HTTP/SSE routes need tornado; on a host
    without it that part cannot run and the phase says so. The API's state
    (``ApiState``, which every route reaches) runs all the same: on the card
    by default and against a CPU twin, through the calls its upload, build,
    query, snapshot and memory routes make. Returns the main path's
    topk_pruned launches."""
    import importlib.util

    from youtu_rag_tpu_torch.api.state import ApiState

    spec = importlib.util.find_spec("tornado")
    if spec is None:
        print("4i: tornado is missing on this host: the API's HTTP/SSE routes (create_app, "
              "serve_api) cannot run here, nor can gates on them; the CPU tests hold the routes "
              "against the JAX package's")
    else:
        print(f"4i: tornado imports on this host ({spec.origin}); the routes over HTTP are held "
              "on the CPU tests only")
    launches = 0
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        facts = write_ingest_corpus(root, seed, n_docs=API_DOCS)
        names = [name for name, _ in facts]
        asked = facts[:: API_DOCS // API_QUESTIONS][:API_QUESTIONS]
        data, twin_data = os.path.join(root, "data"), os.path.join(root, "twin")
        t0 = time.perf_counter()
        state = ApiState(data_dir=data)  # no device: the card
        twin = ApiState(data_dir=twin_data, device="cpu")
        check(state.device.type == "cuda" and twin.device.type == "cpu",
              f"ApiState() is on {state.device}")
        kb, report = api_build(state, root, names)
        twin_kb, twin_report = api_build(twin, root, names)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(kb.device.type == "cuda" and report.processed == API_DOCS and report.failed == 0
              and twin_report.total_chunks == report.total_chunks,
              f"the API's KB on {kb.device}: {report.summary()} / twin {twin_report.summary()}")
        print(f"ApiState() on {state.device}: {API_DOCS} files uploaded and built into "
              f"{report.total_chunks} chunks in {build_s:.1f} s with the CPU twin's [{smi}]")
        rows = kb.store.index.size
        _, rebuild = api_build(state, root, names)
        check(rebuild.skipped == API_DOCS and rebuild.processed == 0
              and kb.store.index.size == rows,
              f"the same files again: {rebuild.summary()}, {kb.store.index.size - rows} rows added")

        # the query route's dense and hybrid calls: one scan each, the twin's answers
        reset_launches()
        dense, hybrid, dense_s = [], [], []
        for _, q in asked:
            t1 = time.perf_counter()
            dense.append(asyncio.run(kb.search(q, top_k=5, similarity_threshold=0.0)))
            torch.cuda.synchronize()
            dense_s.append(time.perf_counter() - t1)
        n_dense = launch_counts()["bfloat16"]
        reset_launches()
        hybrid_s = []
        for _, q in asked:
            t1 = time.perf_counter()
            hybrid.append(asyncio.run(kb.hybrid_retriever.retrieve(q, top_k=5,
                                                                   similarity_threshold=0.0)))
            torch.cuda.synchronize()
            hybrid_s.append(time.perf_counter() - t1)
        n_hybrid = launch_counts()["bfloat16"]
        launches += n_dense + n_hybrid
        check(n_dense == n_hybrid == API_QUESTIONS,
              f"topk_pruned launched {n_dense} times for {API_QUESTIONS} dense searches and "
              f"{n_hybrid} for as many hybrid ones (one each)")
        missing = [name for (name, _), hits in zip(asked, hybrid)
                   if name not in [h.chunk.document_id for h in hits]]
        check(not missing, f"facts not in their hybrid top 5: {missing}")
        for (_, q), got, hyb in zip(asked, dense, hybrid):
            ref = asyncio.run(twin_kb.search(q, top_k=5, similarity_threshold=0.0))
            check(same_up_to_ties(got, ref, TOL), f"dense {q!r}: the card's hits differ from the "
                  "CPU twin's")
            ref = asyncio.run(twin_kb.hybrid_retriever.retrieve(q, top_k=5,
                                                                similarity_threshold=0.0))
            check(same_up_to_ties(hyb, ref, TOL), f"hybrid {q!r}: the card's hits differ from "
                  "the CPU twin's")
        # 16 calls a window: the profiler drops a short window's events
        kernels = device_kernels(lambda: asyncio.run(
            kb.search(asked[0][1], top_k=5, similarity_threshold=0.0)), API_PROFILED)
        scan_us = sum(us for name, (_, us) in kernels.items() if "topk_" in name)
        device = (f"the scan {scan_us / API_PROFILED / 1e3:.4f} ms and every kernel "
                  f"{sum(us for _, us in kernels.values()) / API_PROFILED / 1e3:.4f} ms of device "
                  "time a call" if scan_us else "device time not measured (the profiler "
                  "recorded no scan)")
        print(f"dense kb.search (the query route's call, no HTTP) [{smi}]: {spread(dense_s)} "
              f"host clock over {API_QUESTIONS}; {device}; hybrid {spread(hybrid_s)}")

        # the snapshot route's save, then a restart: a new ApiState rehydrates on the card
        kb.save(os.path.join(data, "snapshots", "api"))
        restarted = ApiState(data_dir=data)
        again = restarted.kbs.get("api")
        check(again is not None and again.device.type == "cuda"
              and again.store.index.count() == kb.store.index.count(),
              f"a new ApiState on the same data dir: {restarted.kbs.names()}")
        reset_launches()
        for (_, q), before in zip(asked[:API_RESTORED], dense):
            got = asyncio.run(again.search(q, top_k=5, similarity_threshold=0.0))
            check([(h.chunk.id, h.score) for h in got] == [(h.chunk.id, h.score) for h in before],
                  f"restored {q!r}: {[(h.chunk.id, h.score) for h in got]} != "
                  f"{[(h.chunk.id, h.score) for h in before]}")
        torch.cuda.synchronize()
        n = launch_counts()["bfloat16"]
        launches += n
        check(n == API_RESTORED, f"{n} topk_pruned launches for {API_RESTORED} restored searches")
        print(f"snapshot and restart: the KB rehydrated on {again.device} and answered "
              f"{API_RESTORED} queries with the same rows and scores")

        # the memory routes' toolkit, after POST /api/memory/config {"memoryEnabled": true}
        state.memory_enabled = True
        agent = asyncio.run(state.get_agent())
        tk, twin_tk = state.memory_toolkit, twin.new_memory_toolkit()
        check(tk is not None and tk.store.store.device.type == "cuda"
              and agent.memory_toolkit is tk,
              f"the memory toolkit is on {tk and tk.store.store.device}")
        rng = np.random.default_rng([seed, 4])
        vocab = sorted({w for _, q in facts for w in q.rstrip("?").split()[4:]})
        for i in range(API_MEMORIES):
            text = " ".join(rng.choice(vocab, size=8))
            for toolkit in (tk, twin_tk):
                asyncio.run(toolkit.add_memory(text, memory_type=("semantic", "episodic")[i % 2],
                                               importance=float(i % 10) / 10))
        reset_launches()
        for i in range(API_MEMORY_QUERIES):
            q = " ".join(rng.choice(vocab, size=3))
            got = asyncio.run(tk.store.search_memories(tk.user_id, q, top_k=10))
            ref = asyncio.run(twin_tk.store.search_memories(twin_tk.user_id, q, top_k=10))
            check(all(m.user_id == tk.user_id for m, _ in got), f"memory {q!r}: another user's hit")
            as_hits = [types.SimpleNamespace(chunk=types.SimpleNamespace(id=m.content),
                                             score=float(s)) for m, s in got]
            as_ref = [types.SimpleNamespace(chunk=types.SimpleNamespace(id=m.content),
                                            score=float(s)) for m, s in ref]
            check(same_up_to_ties(as_hits, as_ref, TOL), f"memory {q!r}: the card's hits differ "
                  "from the CPU twin's")
        torch.cuda.synchronize()
        n = launch_counts()["bfloat16"]
        launches += n
        check(n >= API_MEMORY_QUERIES, f"{n} topk_pruned launches for {API_MEMORY_QUERIES} "
              "memory searches")
        print(f"memory: {API_MEMORIES} items through the toolkit the memory routes build, "
              f"{API_MEMORY_QUERIES} searches on the card equal to the twin's, {n} launches")
        print(f"  topk_pruned launches in 4i: {launches}")
        docs = {}
        for name, _ in asked:
            with open(os.path.join(root, name)) as f:
                docs[name] = f.read()
    # 4j's RetrievalBenchmark and BaseBenchmark run on these KBs, not new ones
    return {"launches": launches, "kb": kb, "twin_kb": twin_kb, "asked": asked, "docs": docs}


# ---------------------------------------------------------------------------
# 4j. the DTR Excel agent and the eval harness on the card
# ---------------------------------------------------------------------------

DTR_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks", "data", "dtr")
DTR_PLANNERS = ("linear", "mcts", "autonomous")
DTR_BIG_ORDERS = 100_000  # a workbook analysts open; Excel's limit is 1,048,576 rows
DTR_BIG_KINDS = {"aggregate": 3, "superlative": 3, "join": 2}  # 8 questions on wb_sales
DTR_LOCAL_MAX_TOKENS = 64
FACT = re.compile(r"The .+? of .+? is (\d+)\.")


def first_difference(got: dict, want: dict) -> str:
    for key in got:
        if got[key] != want.get(key):
            return f"{key}: {str(got[key])[:300]!r} != {str(want.get(key))[:300]!r}"
    return "none"


def fact_answer_rule(fake):
    """A scripted model: search the KB for the question (hybrid: a 256-wide
    hash embedding alone misses one-sentence facts, 4f), then answer with
    the value the top hit's fact sentence states."""

    def rule(messages, tools):
        last = messages[-1]
        if last.role != "tool":
            question = next(m.content for m in reversed(messages) if m.role == "user")
            return fake.tool_response("kb_hybrid_search", {"query": question, "top_k": 3})
        m = FACT.search(last.content or "")
        return fake.text_response(f"The value is {m.group(1)}." if m else "I do not know.")

    return rule


class SandboxClock:
    """Host seconds inside the SMG sandbox (``SheetStateMachine._run_script``)
    while active."""

    def __enter__(self):
        from youtu_rag_tpu_torch.integrations.dtr.smg import SheetStateMachine

        self.seconds, self._cls = 0.0, SheetStateMachine
        self._real = real = SheetStateMachine._run_script

        async def timed(machine, script):
            t0 = time.perf_counter()
            try:
                return await real(machine, script)
            finally:
                self.seconds += time.perf_counter() - t0

        SheetStateMachine._run_script = timed
        return self

    def __exit__(self, *exc):
        self._cls._run_script = self._real


def dtr_and_eval(seed: int, smi: str, api: dict) -> dict:
    """4j: (a) the committed DTR fixture's first four questions of each kind
    (23) through the linear, mcts and autonomous planners of the Excel agent
    that ``get_agent`` builds from ``examples/excel_qa`` on cuda, with a
    memory toolkit on the card for experience priming, against a CPU twin;
    (b) 8 questions over ``wb_sales`` drawn at 100,000 ``orders`` rows;
    (c) the agent on ``yrt_tiny_chat`` on cuda; (d) ``RetrievalBenchmark``
    on 4i's KB and its twin, dense and hybrid, and on an int8 KB of the
    asked documents; (e) ``BaseBenchmark`` as ``run_eval`` drives it over
    4i's 64 facts. Returns the main path's topk_pruned and topk_int8_pruned
    launches."""
    import importlib.util

    from youtu_rag_tpu_torch import run_eval
    from youtu_rag_tpu_torch.agents.config import AgentConfig
    from youtu_rag_tpu_torch.agents.factory import get_agent
    from youtu_rag_tpu_torch.agents.llm import FakeChatClient
    from youtu_rag_tpu_torch.agents.local_llm import LocalChatClient
    from youtu_rag_tpu_torch.bench import dtr
    from youtu_rag_tpu_torch.db.models import EvaluationSample
    from youtu_rag_tpu_torch.db.service import DBService
    from youtu_rag_tpu_torch.eval.retrieval_eval import RetrievalBenchmark
    from youtu_rag_tpu_torch.memory.toolkit import VectorMemoryToolkit
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase
    from youtu_rag_tpu_torch.tools.base import ToolkitConfig
    import youtu_rag_tpu_torch.models.decoder as decoder

    t_phase = time.perf_counter()
    mpl = importlib.util.find_spec("matplotlib")
    print(f"4j: matplotlib imports on this host ({mpl.origin})" if mpl is not None else
          "4j: matplotlib is missing on this host: the chart questions' sandbox cannot draw "
          "(the card and its twin answer them alike); the chart kind is excused from the "
          "gate on the fixture's known outcome")
    excused = () if mpl is not None else ("chart",)
    cfg = load_config("agents", "examples/excel_qa")
    check(cfg.type == "excel", f"examples/excel_qa is of type {cfg.type}")
    launches = {"topk_pruned": 0, "topk_int8_pruned": 0}

    # (a) the fixture's questions through the three planners, card and twin
    with open(os.path.join(DTR_DATA, "questions.json")) as f:
        questions = dtr.first_of_each_kind(json.load(f))
    check(len(questions) == 23, f"{len(questions)} fixture questions, expected 23")
    wbs = {wb: os.path.join(DTR_DATA, wb) for wb in ("wb_sales", "wb_ops")}
    mem = VectorMemoryToolkit({"user_id": "dtr"})  # no device: the card
    twin_mem = VectorMemoryToolkit({"user_id": "dtr", "device": "cpu"})
    check(mem.store.store.device.type == "cuda", f"the memory toolkit is on {mem.store.store.device}")
    searched = [0]
    search_skills = mem.search_skills

    async def counted(*args, **kw):
        searched[0] += 1
        return await search_skills(*args, **kw)

    mem.search_skills = counted
    card, twin, card_s = {}, {}, {}
    reset_launches()
    for planner in DTR_PLANNERS:
        card[planner], card_s[planner] = [], []
        for q in questions:
            t0 = time.perf_counter()
            card[planner].append(asyncio.run(dtr.run_question(
                q, wbs[q["workbook"]], planner, config=cfg, memory_toolkit=mem)))
            card_s[planner].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    counts = launch_counts()
    n_skills = counts["bfloat16"]
    launches["topk_pruned"] += n_skills
    t0 = time.perf_counter()
    for planner in DTR_PLANNERS:
        twin[planner] = [asyncio.run(dtr.run_question(
            q, wbs[q["workbook"]], planner, config=cfg, device="cpu", memory_toolkit=twin_mem))
            for q in questions]
    twin_s = time.perf_counter() - t0
    for planner in DTR_PLANNERS:
        for got, want in zip(card[planner], twin[planner]):
            g, w = dtr.twin_view(got), dtr.twin_view(want)
            check(g == w, f"{planner} {got['question']!r}: the card's run differs from the CPU "
                  f"twin's at {first_difference(g, w)}")
        acc, twin_acc = dtr.accuracy(card[planner]), dtr.accuracy(twin[planner])
        check(acc == twin_acc, f"{planner}: accuracy {acc} against the twin's {twin_acc}")
        rows = card[planner]
        crashed = [r["question"] for r in rows if r["answer"].startswith("error:")]
        check(not crashed, f"{planner}: the agent raised on {crashed}")
        wrong = [(r["kind"], r["question"]) for r in rows if r["kind"] not in excused
                 and bool(r["hit"]) != dtr.expected_hit(planner, r["kind"])]
        check(not wrong, f"{planner}: the fixture's known outcome differs at {wrong}")
        depth = [r["depth"] for r in rows if r["depth"] is not None]
        kinds = sorted({r["kind"] for r in rows})
        by_kind = {k: dtr.accuracy([r for r in rows if r["kind"] == k]) for k in kinds}
        print(f"{planner}: accuracy {acc:.4f} (the twin's {twin_acc:.4f}; by kind {by_kind}), "
              f"{sum(r['llm_calls'] for r in rows) / len(rows):.2f} LLM calls and depth "
              f"{sum(depth) / max(len(depth), 1):.4f} a question; {spread(card_s[planner])} a "
              f"question on the card's host [{smi}]")
    check(n_skills > 0 and all(n == 0 for t, n in counts.items() if t != "bfloat16"),
          f"search_skills launched {counts} for {searched[0]} calls")
    print(f"(a) {len(questions)} questions x {len(DTR_PLANNERS)} planners: every answer, plan, "
          f"code string and event sequence the CPU twin's; search_skills {searched[0]} calls, "
          f"{n_skills} topk_pruned launches; the twin's runs {twin_s:.1f} s")

    # (b) wb_sales at 100,000 orders rows, through the linear planner
    t0 = time.perf_counter()
    big = dtr.gen_workbooks(np.random.default_rng([seed, 18]), n_orders=DTR_BIG_ORDERS)
    big_questions = dtr.gen_questions(big)
    picked, left = [], dict(DTR_BIG_KINDS)
    for q in big_questions:
        if q["workbook"] == "wb_sales" and left.get(q["kind"], 0) > 0:
            left[q["kind"]] -= 1
            picked.append(q)
    gen_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        for sheet, df in big["wb_sales"].items():
            df.to_csv(os.path.join(root, f"{sheet}.csv"), index=False)
        per_q, sandbox = [], []
        for q in picked:
            with SandboxClock() as clock:
                t1 = time.perf_counter()
                row = asyncio.run(dtr.run_question(q, root, "linear", config=cfg))
                per_q.append(time.perf_counter() - t1)
            sandbox.append(clock.seconds)
            check(row["hit"], f"100k rows: {q['question']!r} answered {row['answer'][:200]!r}, "
                  f"gold {q['gold']!r}")
    med = statistics.median(per_q)
    print(f"(b) wb_sales at {DTR_BIG_ORDERS} orders rows (drawn in {gen_s:.1f} s): "
          f"{len(picked)} questions ({DTR_BIG_KINDS}) each answered with its pandas gold value; "
          f"{med:.3f} s a question (median; min {min(per_q):.3f}, max {max(per_q):.3f}), the "
          f"sandbox {statistics.median(sandbox):.3f} s of it and the rest "
          f"{statistics.median([a - b for a, b in zip(per_q, sandbox)]):.3f} s (medians) [{smi}]")

    # (c) the agent on the local chat model, on the card
    chat_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "benchmarks", "models", "yrt_tiny_chat")
    local = AgentConfig.model_validate({**cfg.model_dump(), "model": {
        "provider": "local", "weights_dir": chat_dir, "max_tokens": DTR_LOCAL_MAX_TOKENS}})
    gens, real_generate = [], decoder.generate

    def spy(params, toks, mask, dcfg, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, lengths = real_generate(params, toks, mask, dcfg, **kw)
        torch.cuda.synchronize()
        gens.append({"toks": toks.cpu(), "mask": mask.cpu(), "kw": kw, "out": out.cpu(),
                     "n": int(lengths[0]), "s": time.perf_counter() - t1,
                     "device": toks.device.type})
        return out, lengths

    decoder.generate = spy
    try:
        agent = get_agent(local)  # no device: the card
        t0 = time.perf_counter()
        q = questions[4]
        try:
            rec = asyncio.run(agent.run(q["question"], wbs[q["workbook"]]))
            err = None
        except Exception as e:  # noqa: BLE001 - the gate reports it
            rec, err = None, e
        run_s = time.perf_counter() - t0
    finally:
        decoder.generate = real_generate
    check(err is None, f"the Excel agent on yrt_tiny_chat raised {err!r}")
    check(gens and all(g["device"] == "cuda" for g in gens),
          f"{len(gens)} generate calls, on {sorted({g['device'] for g in gens})}")
    twin_client = LocalChatClient(chat_dir, device="cpu")
    first = gens[0]
    out, lengths = real_generate(twin_client.params, first["toks"], first["mask"], twin_client.cfg,
                                 **{**first["kw"], "generator": twin_client._generator})
    n = first["n"]
    check(int(lengths[0]) == n and torch.equal(out[0, :n].cpu(), first["out"][0, :n]),
          f"the first generate's greedy tokens differ from the CPU twin's: "
          f"{first['out'][0, :n].tolist()} / {out[0, :int(lengths[0])].tolist()}")
    tokens = sum(g["n"] for g in gens)
    gen_time = sum(g["s"] for g in gens)
    print(f"(c) the Excel agent on yrt_tiny_chat (cuda, bf16): {q['question']!r} ran to an end in "
          f"{run_s:.2f} s, {agent.llm_calls} LLM calls, {len(gens)} generates, answer "
          f"{(rec.final_output or '')[:120]!r}; the first generate's {n} greedy tokens the CPU "
          f"twin's; {tokens} tokens in {gen_time:.2f} s of generate: "
          f"{tokens / max(gen_time, 1e-9):.1f} tokens/s [{smi}]")

    # (d) RetrievalBenchmark on 4i's KB and its twin, and on an int8 KB
    qrels = [{"query": question, "relevant": [name]} for name, question in api["asked"]]
    kb, twin_kb = api["kb"], api["twin_kb"]

    def retrieval(kb_, hybrid: bool):
        bench = RetrievalBenchmark(kb_, top_k=15, use_hybrid=hybrid)
        samples = bench.load_qrels(qrels)
        calls = [0]
        retriever = kb_.hybrid_retriever if hybrid else kb_.retriever
        real_batch = retriever.batch_retrieve

        async def counted_batch(*args, **kw):
            calls[0] += 1
            return await real_batch(*args, **kw)

        retriever.batch_retrieve = counted_batch
        try:
            report = asyncio.run(bench.run(samples))
        finally:
            del retriever.batch_retrieve
        return report, samples, calls[0]

    for hybrid, kind in ((False, "dense"), (True, "hybrid")):
        reset_launches()
        t0 = time.perf_counter()
        report, samples, calls = retrieval(kb, hybrid)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        n = launch_counts()["bfloat16"]
        launches["topk_pruned"] += n
        want, want_samples, _ = retrieval(twin_kb, hybrid)
        check(report == want, f"RetrievalBenchmark {kind}: {report} against the twin's {want}")
        swaps = []
        for s, w in zip(samples, want_samples):
            if s.retrieved == w.retrieved:
                continue
            retriever = kb.hybrid_retriever if hybrid else kb.retriever
            twin_retriever = twin_kb.hybrid_retriever if hybrid else twin_kb.retriever
            got_hits = asyncio.run(retriever.retrieve(s.query, top_k=15, similarity_threshold=0.0))
            ref_hits = asyncio.run(twin_retriever.retrieve(s.query, top_k=15,
                                                           similarity_threshold=0.0))
            check(same_up_to_ties(got_hits, ref_hits, TOL),
                  f"RetrievalBenchmark {kind} {s.query!r}: {s.retrieved} against the twin's "
                  f"{w.retrieved}, not near-tie swaps")
            swaps.append((s.query, s.retrieved, w.retrieved))
        for query, got_docs, want_docs in swaps:
            print(f"  near-tie swap within {TOL} ({kind}) {query!r}: {got_docs} / {want_docs}")
        check(n >= 1, f"RetrievalBenchmark {kind} launched topk_pruned {n} times")
        print(f"(d) RetrievalBenchmark {kind} on 4i's KB ({len(qrels)} qrels, top 15): {report} "
              f"the twin's; {len(swaps)} lists differ by near-tie swaps; {n} topk_pruned "
              f"launches for {calls} batch_retrieve call(s); {run_s * 1e3:.1f} ms [{smi}]")
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        paths = []
        for name, text in api["docs"].items():
            paths.append(os.path.join(root, name))
            with open(paths[-1], "w") as f:
                f.write(text)
        int8 = KnowledgeBase("dtr-eval-int8", tier_config("dtr-eval", "int8"), device="cuda")
        int8_twin = KnowledgeBase("dtr-eval-int8-cpu", tier_config("dtr-eval", "int8"),
                                  device="cpu")
        for kb_ in (int8, int8_twin):
            asyncio.run(kb_.build_files(sorted(paths)))
    reset_launches()
    report, samples, calls = retrieval(int8, False)
    torch.cuda.synchronize()
    n8 = launch_counts()["int8"]
    launches["topk_int8_pruned"] += n8
    want, want_samples, _ = retrieval(int8_twin, False)
    check(report == want and [s.retrieved for s in samples] == [w.retrieved for w in want_samples],
          f"RetrievalBenchmark int8: {report} against the twin's {want}")
    check(n8 >= 1, f"the int8 KB launched topk_int8_pruned {n8} times")
    print(f"(d) RetrievalBenchmark dense on an int8 KB of the {len(paths)} asked documents: "
          f"{report} the twin's, every list equal; {n8} topk_int8_pruned launches for {calls} "
          "batch_retrieve call(s)")

    # (e) BaseBenchmark as run_eval drives it, over the 64 facts
    values = {}
    for name, text in api["docs"].items():
        m = FACT.search(text)
        check(m is not None, f"{name} states no fact")
        values[name] = m.group(1)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        data = os.path.join(root, "facts.jsonl")
        with open(data, "w") as f:
            for name, question in api["asked"]:
                f.write(json.dumps({"question": question, "answer": values[name]}) + "\n")
        stats, walls = {}, {}
        for side, kb_, device in (("card", kb, None), ("twin", twin_kb, "cpu")):
            agent_cfg = AgentConfig(type="simple", toolkits={
                "kb_search": ToolkitConfig(name="kb_search", config={"kb": kb_})})
            agent = get_agent(agent_cfg, client=FakeChatClient(
                rule_fn=fact_answer_rule(FakeChatClient)), device=device)
            db = DBService(f"sqlite:///{root}/eval-{side}.db")
            argv = ["--data", data, "--exp-id", "facts", "--processor", "exact_match"]
            argv += [] if device is None else ["--device", device]
            reset_launches()
            t0 = time.perf_counter()
            stats[side] = asyncio.run(run_eval.main(argv, agent=agent, db=db))
            if device is None:
                torch.cuda.synchronize()
                n_eval = launch_counts()["bfloat16"]
                launches["topk_pruned"] += n_eval
            walls[side] = time.perf_counter() - t0
            judged = db.count(EvaluationSample, {"stage": "judged", "exp_id": "facts"})
            check(judged == len(api["asked"]), f"{side}: {judged} samples judged in the DB")
    per_sample = stats["card"]["avg_time_cost"]
    for s in stats.values():
        s.pop("avg_time_cost")
    check(stats["card"] == stats["twin"], f"BaseBenchmark: {stats['card']} against the twin's "
          f"{stats['twin']}")
    check(n_eval >= len(api["asked"]),
          f"{n_eval} topk_pruned launches for {len(api['asked'])} samples")
    print(f"(e) BaseBenchmark through run_eval (simple agent, kb_hybrid_search on 4i's KB on cuda, "
          f"exact_match): {stats['card']} the twin's; {len(api['asked'])} samples judged in "
          f"sqlite; {n_eval} topk_pruned launches; {walls['card'] / len(api['asked']) * 1e3:.1f} ms a "
          f"sample of run wall time, {per_sample * 1e3:.1f} ms a sample's rollout (host clock, "
          f"concurrency 4) [{smi}]")
    print(f"  launches in 4j: {launches}; 4j {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# 4k. the MCP tool server on the card
# ---------------------------------------------------------------------------

MCP_DOCS = 2048  # 4f's file count, one short fact document each
MCP_QUESTIONS = 64
MCP_STDIO_DOCS = 512  # every fourth document: (a)'s asked ones among them
MCP_PROFILED = 16


def mcp_corpus(seed: int, root: str) -> tuple[list[str], list[str]]:
    """MCP_DOCS short documents, each 4f's title and fact sentence without
    its paragraphs, and one question each."""
    facts = write_ingest_corpus(root, seed, n_docs=MCP_DOCS, chars=0)
    texts = []
    for name, _ in facts:
        with open(os.path.join(root, name)) as f:
            texts.append(f.read().strip())
    return texts, [q for _, q in facts]


def rpc_call(rid: int, name: str, arguments: dict) -> dict:
    return {"jsonrpc": "2.0", "id": rid, "method": "tools/call",
            "params": {"name": name, "arguments": arguments}}


async def mcp_serve(mcp, router, msgs: list[dict]) -> tuple[list, list[float]]:
    """Each message through ``handle_message`` (the router built first);
    the responses and each one's host seconds."""
    await router.build()
    schemas = router.schemas()
    out, secs = [], []
    for m in msgs:
        t0 = time.perf_counter()
        out.append(await mcp.handle_message(m, router, schemas))
        secs.append(time.perf_counter() - t0)
    return out, secs


def reply_text(resp: dict) -> str:
    return resp["result"]["content"][0]["text"]


async def mcp_start(tk) -> float:
    """Start the port's MCP client over stdio (spawn to tools/list): seconds."""
    t0 = time.perf_counter()
    await tk.build()
    return time.perf_counter() - t0


async def mcp_stdio(tk, docs: list[str], questions: list[str]) -> dict:
    """Over the started client: the build, each retrieve timed, run_snippet."""
    out = {"names": sorted(t["function"]["name"] for t in tk.get_tools_in_openai()),
           "build": await tk.call_tool("rag_build", {"texts": docs}), "answers": [], "secs": []}
    for q in questions:
        t1 = time.perf_counter()
        out["answers"].append(await tk.call_tool("rag_retrieve", {"query": q}))
        out["secs"].append(time.perf_counter() - t1)
    out["snippet"] = await tk.call_tool("run_snippet", {"code": "print(7*6)"})
    return out


@contextlib.contextmanager
def client_loop(tk):
    """An event loop on a thread of its own for the MCP client ``tk``, whose
    server process is stopped, and the loop closed, on the way out."""
    loop = asyncio.new_event_loop()
    runner = threading.Thread(target=loop.run_forever, daemon=True)
    runner.start()
    try:
        yield loop
    finally:
        asyncio.run_coroutine_threadsafe(tk.cleanup(), loop).result(timeout=60)
        loop.call_soon_threadsafe(loop.stop)
        runner.join(timeout=60)
        loop.close()


def mcp_on_card(seed: int, smi: str) -> dict:
    """4k: the MCP tool server (``start_tools_mcp``) over ``rag`` and
    ``codesnip``, its KBs on the card: in process through
    ``handle_message`` against a CPU twin, then over stdio from the port's
    MCP client. Returns the main path's topk_pruned launches."""
    import importlib.util

    from youtu_rag_tpu_torch import start_tools_mcp as mcp
    from youtu_rag_tpu_torch.ops import _build
    from youtu_rag_tpu_torch.tools.base import ToolkitConfig
    from youtu_rag_tpu_torch.tools.mcp_client import MCPToolkit

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as root:
        docs, questions = mcp_corpus(seed, root)
    at = list(range(0, MCP_DOCS, MCP_DOCS // MCP_QUESTIONS))[:MCP_QUESTIONS]
    asked = [questions[i] for i in at]

    # (b)'s server process starts (torch's import, the CUDA context, the
    # toolkits: ~10 s of its own) on a loop of its own while (a) builds its
    # KBs and runs the CPU twin; the card's timed calls wait for it
    lib = _build.library_path("ivf_topk_bf16")
    check(lib.exists(), f"phase 2 built no {lib.name}")
    built, stamp = sorted(os.listdir(_build.BUILD_DIR)), lib.stat().st_mtime_ns
    path = os.pathsep.join(p for p in (here, os.environ.get("PYTHONPATH")) if p)
    tk = MCPToolkit(ToolkitConfig(mode="mcp", config={
        "command": sys.executable, "env": {"PYTHONPATH": path}, "timeout": 120.0,
        "args": ["-m", "youtu_rag_tpu_torch.start_tools_mcp", "--toolkits", "rag", "codesnip"]}))
    with client_loop(tk) as loop:
        started = asyncio.run_coroutine_threadsafe(mcp_start(tk), loop)
        # (a) in process, through handle_message alone
        card = mcp.make_router(["rag", "codesnip"])
        twin = mcp.make_router(["rag", "codesnip"], "cpu")
        check(card.toolkits[0].kb.device.type == "cuda"
              and twin.toolkits[0].kb.device.type == "cpu",
              f"the rag toolkit's KB is on {card.toolkits[0].kb.device}")
        head = [{"jsonrpc": "2.0", "id": 1, "method": "initialize",
                 "params": {"protocolVersion": "2024-11-05"}},
                {"jsonrpc": "2.0", "method": "notifications/initialized"},
                {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
                rpc_call(3, "rag_build", {"texts": docs}),
                rpc_call(4, "run_snippet", {"code": "print(7*6)"}),
                {"jsonrpc": "2.0", "id": 5, "method": "resources/list"}]
        retrieves = [rpc_call(10 + i, "rag_retrieve", {"query": q}) for i, q in enumerate(asked)]
        t0 = time.perf_counter()
        got_head, _ = asyncio.run(mcp_serve(mcp, card, head))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        want_head, _ = asyncio.run(mcp_serve(mcp, twin, head))
        want, twin_secs = asyncio.run(mcp_serve(mcp, twin, retrieves))
        small_docs = docs[:: MCP_DOCS // MCP_STDIO_DOCS]
        small = mcp.make_router(["rag"])
        asyncio.run(mcp_serve(mcp, small, [rpc_call(3, "rag_build",
                                                    {"texts": small_docs})]))
        # the card's timed calls once the server process has started
        start_s = started.result(timeout=300)
        reset_launches()
        got, secs = asyncio.run(mcp_serve(mcp, card, retrieves))
        torch.cuda.synchronize()
        n_a = launch_counts()["bfloat16"]
        check(got_head[1] is None and got_head == want_head,
              f"(a) initialize, tools/list, rag_build, run_snippet, an unknown method: "
              f"{got_head} against the twin's {want_head}")
        tools = [t["name"] for t in got_head[2]["result"]["tools"]]
        check(tools == ["rag_build", "rag_clear", "rag_retrieve", "rag_stats", "run_snippet"],
              f"(a) tools/list: {tools}")
        check(reply_text(got_head[3]) == f"indexed {MCP_DOCS} chunks from {MCP_DOCS} documents",
              f"(a) rag_build: {reply_text(got_head[3])!r}")
        check(reply_text(got_head[4]) == "42" and not got_head[4]["result"]["isError"],
              f"(a) run_snippet print(7*6): {got_head[4]}")
        check(got_head[5].get("error", {}).get("code") == -32601,
              f"(a) resources/list: {got_head[5]}")
        check(n_a == MCP_QUESTIONS, f"(a) {n_a} topk_pruned launches for {MCP_QUESTIONS} "
              "rag_retrieve calls (one each)")
        missing = [q for i, q, r in zip(at, asked, got) if docs[i] not in reply_text(r)]
        check(not missing, f"(a) facts not in their rag_retrieve top 5: {missing[:4]}")
        ties = 0
        for q, g, w in zip(asked, got, want):
            if reply_text(g) == reply_text(w):
                continue
            ties += 1
            hits = [asyncio.run(r.toolkits[0].kb.search(q, top_k=5, similarity_threshold=0.0))
                    for r in (card, twin)]
            check(same_up_to_ties(*hits, TOL), f"(a) rag_retrieve {q!r}: the card's hits "
                  "differ from the CPU twin's")
        msg = retrieves[0]
        schemas = card.schemas()
        kernels = device_kernels(lambda: asyncio.run(mcp.handle_message(msg, card, schemas)),
                                 MCP_PROFILED)
        scan_us = sum(us for name, (_, us) in kernels.items() if "topk_" in name)
        device = (f"the scan {scan_us / MCP_PROFILED / 1e3:.4f} ms and every kernel "
                  f"{sum(us for _, us in kernels.values()) / MCP_PROFILED / 1e3:.4f} ms of "
                  "device time a call" if scan_us else "device time not measured (the "
                  "profiler recorded no scan)")
        print(f"(a) in process [{smi}]: initialize, tools/list {tools}, rag_build of "
              f"{MCP_DOCS} short fact documents ({build_s:.1f} s, the CPU twin's build apart), "
              f"run_snippet '42', an unknown method -32601: the twin's responses; "
              f"{MCP_QUESTIONS} rag_retrieve through handle_message: every fact in its top 5, "
              f"{n_a} topk_pruned launches, the twin's text ({ties} up to near-ties within "
              f"{TOL}); {spread(secs)} host clock a retrieve (the CPU twin, while the server "
              f"process started, {spread(twin_secs)}); "
              f"{device}")
        del card, twin

        # (a) again on the smaller build that (b) serves
        reset_launches()
        ref, _ = asyncio.run(mcp_serve(mcp, small, retrieves))
        torch.cuda.synchronize()
        n_small = launch_counts()["bfloat16"]
        check(n_small == MCP_QUESTIONS, f"(a) {n_small} topk_pruned launches for "
              f"{MCP_QUESTIONS} rag_retrieve calls on the {MCP_STDIO_DOCS}-document build")
        del small

        # (b) over stdio: the port's MCP client against a server process on the card
        out = asyncio.run_coroutine_threadsafe(mcp_stdio(tk, small_docs, asked), loop).result(
            timeout=300)
        check(sorted(os.listdir(_build.BUILD_DIR)) == built and lib.stat().st_mtime_ns == stamp,
              "(b) the server process built a kernel library instead of loading phase 2's")
        stdio_build = f"indexed {MCP_STDIO_DOCS} chunks from {MCP_STDIO_DOCS} documents"
        check(out["names"] == tools and out["snippet"] == "42" and out["build"] == stdio_build,
              f"(b) over stdio: tools {out['names']}, run_snippet {out['snippet']!r}, "
              f"{out['build']!r}")
        differ = [q for q, a, r in zip(asked, out["answers"], ref) if a != reply_text(r)]
        check(not differ, f"(b) over stdio, answers that differ from the in-process server's on "
              f"the same build: {differ[:4]}")
        spec = importlib.util.find_spec("tornado")
        sse = ("tornado is missing on this host: the SSE transport (--transport sse) cannot run "
               "here; the CPU tests hold it" if spec is None else
               f"tornado imports on this host ({spec.origin}); the SSE transport is held by the "
               "CPU tests only")
        print(f"(b) over stdio [{smi}]: the server process started (spawn to tools/list, while "
              f"(a) built) in {start_s:.1f} s and loaded phase 2's kernel libraries (none built); "
              f"{MCP_STDIO_DOCS} documents, {MCP_QUESTIONS} rag_retrieve answers equal to the "
              f"in-process server's on the same build ({n_small} launches there); "
              f"{spread(out['secs'])} host clock a retrieve (the first "
              f"{out['secs'][0] * 1e3:.1f} ms)\n(c) {sse}")
        launches = n_a + n_small
        print(f"  topk_pruned launches in 4k: {launches}; 4k "
              f"{time.perf_counter() - t_phase:.1f} s")
        return {"launches": launches}


# ---------------------------------------------------------------------------
# 5. main path at full size
# ---------------------------------------------------------------------------


def time_ms(fn, bursts: int = 5, burst: int = 20, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around a burst of back-to-back
    calls (so the host's enqueue overlaps the card's work), divided by the
    burst length; the median over bursts. Every index here is well past
    the 50 MB L2 (the int4 one, 0.40 GB, is 8x it), so every call reads it
    from HBM."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(bursts):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(burst):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / burst)
    return statistics.median(times)


def profile_split(fn, calls: int = 10, top: int = 4, graph: bool = False) -> None:
    """Device time per call of the ``top`` kernels ``fn`` launches, and of
    all of them (torch.profiler, through ``device_kernels``: a window that
    records no device event is profiled again). Where the profiler lost
    records (a kind fewer than ``calls`` times; with ``graph``, fewer
    kernels than ``calls`` times those of one call's CUDA graph), it says
    so and prints no split; with ``graph`` it then names what one call
    enqueues (``graph_nodes``) and gives the held call's time in all (CUDA
    events) instead. No time is printed that was not measured."""
    ran = device_kernels(fn, calls)
    rows = [(us / calls, key) for key, (count, us) in ran.items() if us > 0 and count >= calls]
    lost = not rows or any(count < calls for count, _ in ran.values())
    nodes = graph_nodes(fn) if graph else []
    if graph:
        recorded = sum(count for key, (count, _) in ran.items()
                       if not any(w in key.lower() for w in ("memset", "memcpy")))
        lost = lost or recorded < calls * sum(kind == "kernel" for kind, _ in nodes)
    if lost:
        seen = ", ".join(f"{short_kernel(key)} x{count}" for key, (count, _) in ran.items())
        print(f"  device time per call: torch.profiler lost records of {calls} calls (recorded: "
              f"{seen or 'none'})" + (f"; one call enqueues {graph_text(nodes)}; the held call "
                                      f"{time_held_ms(fn):.4f} ms in all (CUDA events)"
                                      if graph else ""))
        return
    print(f"  device time per call: {sum(us for us, _ in rows) / 1e3:.4f} ms in all; " + "; ".join(
        f"{short_kernel(name)} {us / 1e3:.4f} ms" for us, name in sorted(rows, reverse=True)[:top]))


def short_kernel(name: str) -> str:
    return name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0][:48]


def bound(tier: str, part: str, n: int, d: int, qn: int, k: int) -> tuple[float, str]:
    """Least time the card could take: the larger of the bytes the call
    must move (each input read once, each output written once) over the
    HBM rate, and its 2·q·N·d operations over the tensor-core peak of
    their type. Returns (ms, "bytes" or "operations")."""
    if tier == "bfloat16":
        nbytes = n * d * 2 + n * 4 + qn * d * 4 + qn * k * 8
        ops_ms = 2 * qn * n * d / BF16_PEAK[part] * 1e3
    else:
        row_bytes = d if tier == "int8" else d // 2
        nbytes = n * row_bytes + n * 8 + qn * d * 4 + qn * k * 8
        ops_ms = 2 * qn * n * d / INT8_PEAK[part] * 1e3
    bytes_ms = nbytes / HBM_PEAK[part] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def int_mm_rows(qn: int) -> int:
    """The query rows ``library_call`` pads int8 queries to: torch._int_mm
    takes more than 16 rows, in multiples of 8, so the larger of 32 and
    ``qn`` rounded up to a multiple of 8."""
    return max(32, -(-qn // 8) * 8)


def library_call(tier: str, qdev, x, scales, bias, k: int):
    """One PyTorch call computing the same function (the port never calls
    it), with its description; None where PyTorch has none."""
    if tier == "bfloat16":
        q16 = qdev.to(torch.bfloat16)
        try:
            torch.mm(q16, x.T, out_dtype=torch.float32)
            return ("torch.topk(torch.mm(q, x.T, out_dtype=float32) + bias, k)",
                    lambda: torch.topk(torch.mm(q16, x.T, out_dtype=torch.float32) + bias, k))
        except (RuntimeError, TypeError):
            return ("torch.topk(torch.mm(q, x.T).float() + bias, k)",
                    lambda: torch.topk(torch.mm(q16, x.T).float() + bias, k))
    if tier == "int8":
        from youtu_rag_tpu_torch.ops.topk import quantize_rows_int8

        qq, qs = quantize_rows_int8(qdev)
        qn = qq.shape[0]
        qpad = torch.zeros((int_mm_rows(qn), qq.shape[1]), dtype=torch.int8, device=qq.device)
        qpad[:qn] = qq
        sc = qs[:, None] * scales[None, :]

        def call():
            acc = torch._int_mm(qpad, x.T)[:qn]
            return torch.topk(acc.float() * sc + bias, k)
        try:
            call()
        except (RuntimeError, TypeError) as e:
            return (f"none: torch._int_mm refused these shapes ({e})", None)
        return (f"torch.topk(torch._int_mm(q_pad{qpad.shape[0]}, x.T)[:q].float() * (qs x xs) "
                "+ bias, k)", call)
    return ("none: PyTorch has no one-call product of int8 queries with packed int4 rows", None)


def full_size_data(seed: int, rows: int = ROWS, d: int = 768, qn: int = 8):
    """Phase 5's data: seeded unit vectors drawn on the card (a host draw
    took ~19 s) and handed to ``add`` as numpy, their chunks, and queries
    (query 0 a stored row: its top-1 is known). Returns (vecs, chunks,
    queries)."""
    from youtu_rag_tpu_torch.core.types import Chunk

    v = torch.randn(rows, d, generator=torch.Generator(device="cuda").manual_seed(seed),
                    device="cuda")
    vecs = (v / v.norm(dim=1, keepdim=True)).cpu().numpy()
    del v
    chunks = [Chunk(f"c{i}", f"doc{i // 64}", "", i % 64) for i in range(rows)]
    queries = np.random.default_rng(seed).standard_normal((qn, d), dtype=np.float32)
    queries[0] = vecs[rows // 2]
    return vecs, chunks, queries


SWEEP_KS = (10, 64, 256, 1024)  # phase 5's brute scans and their library calls


def full_size(seed: int, part: str) -> tuple[dict[str, dict], dict[str, dict]]:
    """Returns (each tier's results, and under "data" the vectors, chunks,
    queries and each tier's index and hits, which phase 5f reuses; the bf16
    and int8 indexes' device tensors and queries, which phase 5d reuses)."""
    from youtu_rag_tpu_torch.core.config import IndexConfig
    from youtu_rag_tpu_torch.index.device_index import DeviceVectorIndex

    kernels = ops()
    rows, d, qn, top_k, batch = ROWS, 768, 8, 10, 65536
    t0 = time.perf_counter()
    # one set of unit vectors for the three tiers
    vecs, chunks, queries = full_size_data(seed, rows, d, qn)
    qpad = queries / np.linalg.norm(queries, axis=1, keepdims=True)  # as search() prepares it
    qdev = torch.from_numpy(qpad.astype(np.float32)).cuda()
    print(f"full size: {rows} x {d} unit vectors made in {time.perf_counter() - t0:.1f} s")

    out, keep = {"data": {"vecs": vecs, "chunks": chunks, "queries": queries, "hits": {}}}, {}
    for tier in TIERS:
        kernel, plain, quantize = kernels[tier]
        index = DeviceVectorIndex(d, IndexConfig(storage_dtype=tier, metric="cosine"), device="cuda")
        index.reserve(rows)
        t0 = time.perf_counter()
        for start in range(0, rows, batch):
            index.add(chunks[start : start + batch], vecs[start : start + batch])
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0

        reset_launches()
        hits = index.search(queries, top_k=top_k)
        torch.cuda.synchronize()
        counts = launch_counts()
        launches = counts[tier]
        x, b = index._vectors[:rows], index._bias[:rows]
        extra = () if quantize is None else (index._scales[:rows],)
        scale_bytes = 0 if quantize is None else index._scales.numel() * 4
        print(f"{tier}: filled in {fill_s:.1f} s; nbytes() {index.nbytes()} "
              f"({index.nbytes() / 1e9:.3f} GB, scales not counted), scales {scale_bytes} bytes; "
              f"search launches {counts}")
        check(launches > 0, f"{tier}: index.search never launched {KERNEL_NAMES[tier]}")
        check(all(n == 0 for t, n in counts.items() if t != tier), f"{tier}: other kernels ran")
        check(len(hits) == qn and all(len(h) == top_k for h in hits), f"{tier}: wrong shape")
        check(all(np.isfinite(s) for h in hits for _, s in h), f"{tier}: non-finite scores")
        check(hits[0][0][0].id == f"c{rows // 2}", f"{tier}: query 0 top hit {hits[0][0][0].id}")
        out["data"]["hits"][tier] = hit_lists(hits)
        out["data"].setdefault("index", {})[tier] = index  # 5f shards its rows

        # the same device tensors the search used, through the plain version
        got_rows = torch.tensor([[index._id_to_row[c.id] for c, _ in h] for h in hits],
                                dtype=torch.int32)
        got_s = torch.tensor([[s for _, s in h] for h in hits], dtype=torch.float32)
        k_kernel = top_k
        if tier == "bfloat16":
            want = plain(qdev, x, b, top_k)
            err = compare_topk((got_s, got_rows), want, plain_scores(qdev, x, b).cpu(), tier)
        elif tier == "int8":
            err = compare_exact((got_s, got_rows), plain(qdev, x, *extra, b, top_k), tier)
        else:
            # int4: the kernel's k2 candidates, then the host re-rank
            k_kernel = 64
            cand = kernel(qdev, x, *extra, b, k_kernel)
            torch.cuda.synchronize()
            want = plain(qdev, x, *extra, b, k_kernel)
            err = compare_exact(cand, want, "int4 candidates")
            rs, rr = index._host_rerank_candidates(qpad, want[0].cpu().numpy(), want[1].cpu().numpy(),
                                                   index._host_q8, index._host_s8, top_k)
            check(np.array_equal(got_rows.numpy(), rr) and np.array_equal(got_s.numpy(), rs),
                  "int4: the search's re-ranked rows differ from the plain version's")
        print(f"{tier}: search (q = {qn}, top_k = {top_k}, kernel k = {k_kernel}) matches the plain version")

        res = {"launches": launches, "err": err, "k": k_kernel}
        for k in SWEEP_KS:
            ms = time_ms(lambda: kernel(qdev, x, *extra, b, k))
            bms, by = bound(tier, part, rows, d, qn, k)
            row_bytes = {"bfloat16": 2 * d, "int8": d, "int4": d // 2}[tier]
            gbs = (rows * (row_bytes + (4 if tier == "bfloat16" else 8))) / ms / 1e6
            desc, call = library_call(tier, qdev, x, *(extra or (None,)), b, k)
            lib_ms = None if call is None else time_ms(call)
            print(f"  {KERNEL_NAMES[tier]} {rows}x{d} q={qn} k={k}: {ms:.4f} ms/batch, {gbs:.1f} GB/s "
                  f"({gbs / (HBM_PEAK[part] / 1e9) * 100:.1f}% of {HBM_PEAK[part] / 1e12:.2f} TB/s); "
                  f"bound {bms:.4f} ms ({by}); library "
                  f"{'null' if call is None else format(lib_ms, '.4f') + ' ms'}")
            res.setdefault("sweep", {})[k] = ms
            res.setdefault("library_sweep", {})[k] = lib_ms
            if k == k_kernel:
                res.update(ms=ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)
        res["plain_ms"] = time_ms(lambda: plain(qdev, x, *extra, b, k_kernel), bursts=3, burst=5)
        earlier = EARLIER_MS.get(KERNEL_NAMES[tier])
        print(f"  k = {k_kernel}: plain {res['plain_ms']:.4f} ms; library "
              f"[{desc if call else 'null'}]"
              + ("" if earlier is None else f"; the earlier design (a scan kernel, then a merge "
                 f"launch) recorded {earlier} ms, now {res['ms']:.4f} ms against a bound of "
                 f"{res['bound_ms']:.4f} ms"))
        profile_split(lambda: kernel(qdev, x, *extra, b, k_kernel), graph=True)
        # one kernel after its memsets: no merge launch, no host cast or
        # quantization of the queries, no sort
        nodes = check_one_scan(f"{tier} brute", lambda: kernel(qdev, x, *extra, b, k_kernel),
                               kernel)
        print(f"  one {KERNEL_NAMES[tier]} call (k = {k_kernel}) enqueues {graph_text(nodes)}")
        out[tier] = res
        if tier != "int4":
            keep[tier] = {"q": qdev, "x": x, "extra": extra, "bias": b}
        del index, x, b, extra, hits
        torch.cuda.empty_cache()
    out["shapes"] = brute_shapes(seed, part)
    return out, keep


# Rows 1-2 at the main path's other shapes: (rows, width, queries, k, tiers,
# one user's filter in the bias). (b) phase 4g's memory index, 1,024 users'
# 256 memories each, with a user's filter (search_memories asks the store
# for top_k * 3); (c) one of phase 5f's four shards of phase 5's index; (d)
# phase 4k's MCP knowledge base, 2,048 one-chunk documents at the hash
# embedder's width.
BRUTE_SHAPES = {"(b) 4g memory, filtered": (1 << 18, 256, 1, 15, ("bfloat16",), True),
                "(c) a 5f shard": (1 << 18, 768, 8, 10, ("bfloat16", "int8"), False),
                "(d) 4k MCP KB": (2048, 512, 1, 10, ("bfloat16",), False)}
L2_BYTES = 50 << 20


def brute_shapes(seed: int, part: str) -> dict[str, dict]:
    """Rows 1-2 at BRUTE_SHAPES on seeded unit rows: each call held to its
    plain version, then its device time (``time_held_ms``, L2 cold where
    the index's bytes exceed the L2) beside its bound and one PyTorch call's
    (``library_call``). Returns {"<tier> <shape>": {ms, bound_ms,
    library_ms, err}}."""
    from youtu_rag_tpu_torch.ops.topk import NEG_INF

    out = {}
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    for label, (rows, d, qn, k, tiers, filtered) in BRUTE_SHAPES.items():
        x = torch.randn(rows, d, generator=g, device="cuda")
        x /= x.norm(dim=1, keepdim=True)
        q = torch.randn(qn, d, generator=g, device="cuda")
        q /= q.norm(dim=1, keepdim=True)
        bias = torch.zeros(rows, device="cuda")
        if filtered:  # one user's 256 rows, one in five of them live
            bias.fill_(NEG_INF)
            bias[513 * 256 : 514 * 256 : 5] = 0.0
        full = plain_scores(q, x.to(torch.bfloat16), bias).cpu()
        for tier in tiers:
            kernel, plain, quantize = ops()[tier]
            stored = (x.to(torch.bfloat16),) if quantize is None else quantize(x)
            what = f"{KERNEL_NAMES[tier]} {label}"
            err = compare_tier(tier, kernel(q, *stored, bias, k), plain(q, *stored, bias, k), full,
                               what)
            cold = stored[0].numel() * stored[0].element_size() > L2_BYTES
            ms = time_held_ms(lambda: kernel(q, *stored, bias, k), cold=cold)
            bms, by = bound(tier, part, rows, d, qn, k)
            desc, call = library_call(tier, q, stored[0], *(stored[1:] or (None,)), bias, k)
            lib_ms = None if call is None else time_held_ms(call, cold=cold)
            print(f"  {what} ({rows} x {d}, q = {qn}, k = {k}, L2 {'cold' if cold else 'warm'}): "
                  f"{ms:.4f} ms held, bound {bms:.4f} ms ({by}), {bms / ms * 100:.0f} % of it; "
                  f"library {'null' if call is None else format(lib_ms, '.4f') + ' ms'} [{desc}]")
            out[f"{tier} {label}"] = {"ms": ms, "bound_ms": bms, "library_ms": lib_ms, "err": err}
        del x, q, bias, full, stored
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 5c. main path at full size, IVF
# ---------------------------------------------------------------------------

IVF_SETTINGS = dict(block_rows=1024, n_lists=1024, n_probe=64, ivf_adaptive_margin=0.15,
                    ivf_recall_target=0.95)  # configs/rag/ivf_int8.yaml's index


def clustered_rows(seed: int, rows: int, d: int, qn: int):
    """scripts/bench_scale.py:83-100's generator on the card: unit rows
    around 1024 unit centers (noise 0.7 / sqrt(d)), queries at half the
    noise around centers 0..qn-1. Returns host arrays (rows, queries)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.randn(1024, d, generator=g, device="cuda")
    centers /= centers.norm(dim=1, keepdim=True)
    noise = 0.7 / np.sqrt(d)
    out = np.empty((rows, d), np.float32)
    for i in range(0, rows, 1 << 18):
        m = min(1 << 18, rows - i)
        cid = torch.randint(0, 1024, (m,), generator=g, device="cuda")
        v = centers[cid] + noise * torch.randn(m, d, generator=g, device="cuda")
        out[i : i + m] = (v / v.norm(dim=1, keepdim=True)).cpu().numpy()
    q = centers[:qn] + 0.5 * noise * torch.randn(qn, d, generator=g, device="cuda")
    return out, (q / q.norm(dim=1, keepdim=True)).cpu().numpy()


HOLD_CYCLES = 4_000_000  # a ~2 ms spin of the card: more than the host takes to enqueue a call


def time_held_ms(fn, calls: int = 20, warmup: int = 3, cold: bool = False) -> float:
    """Device time of one call, the median over ``calls``. Before each call
    a spin kernel (``torch.cuda._sleep``) holds the card while the host
    enqueues the call, so the CUDA events around it see the call's device
    time, not the host's enqueue gaps (which exceed the device time of a
    call this short, and vary with the host). With ``cold`` a 1 GiB write
    first evicts the 50 MB L2 (a probed plan reads tens of MB, which
    back-to-back calls would find cached)."""
    flush = torch.empty(256 << 20, dtype=torch.float32, device="cuda") if cold else None
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        if cold:
            flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_kernels(fn, calls: int) -> dict[str, tuple[int, float]]:
    """Every device activity of ``calls`` calls of ``fn`` (torch.profiler):
    name → (count, device us in all). The profiler may drop a short
    window's device events, some or all: a window that records none is
    profiled again, every other attempt after a warm-up step of the same
    calls (a schedule whose first step records nothing); {} if none
    records any."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(6):
        warm = attempt % 2 == 1
        ready = []  # the recorded step's events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1) if warm else None,
                     on_trace_ready=(lambda p: ready.append(p.key_averages())) if warm else None
                     ) as prof:
            for _step in range(2 if warm else 1):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                if warm:
                    prof.step()
        out = {}
        for e in (ready[0] if warm and ready else [] if warm else prof.key_averages()):
            # (the schedule's step annotation also shows on the device)
            if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith("ProfilerStep"):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            out[e.key] = (e.count, us)
        if out:
            return out
    return {}


GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
                    6: "event wait", 7: "event record", 10: "alloc", 11: "free"}


def graph_nodes(fn) -> list[tuple[str, str]]:
    """What one call of ``fn`` enqueues on the card, from the driver: the call
    captured into a CUDA graph, its nodes as (kind, kernel name; "" for other
    kinds and where the driver gives no name). Exact where the profiler is
    not: torch.profiler may lose a short window's device records, at times
    all of them, attempt after attempt."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    p, size = ctypes.c_void_p, ctypes.c_size_t

    def call(name, *args):
        err = getattr(cu, name)(*args)
        check(err == 0, f"graph_nodes: {name} returned CUDA error {err}")

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    raw = p(graph.raw_cuda_graph())
    n = size(0)
    call("cuGraphGetNodes", raw, None, ctypes.byref(n))
    nodes = (p * n.value)()
    call("cuGraphGetNodes", raw, nodes, ctypes.byref(n))
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", p(node), ctypes.byref(kind))
        label = ""
        if kind.value == 0:
            # CUDA_KERNEL_NODE_PARAMS_v2: func, 7 uints, kernelParams, extra, kern, ctx
            params = (p * 10)()
            call("cuGraphKernelNodeGetParams_v2", p(node), params)
            name = ctypes.c_char_p()
            for handle, getter in ((params[0], "cuFuncGetName"), (params[7], "cuKernelGetName")):
                get = getattr(cu, getter, None)  # (drivers of CUDA 12.3 and later)
                if handle and get is not None and get(ctypes.byref(name), p(handle)) == 0:
                    label = (name.value or b"").decode()
                    break
        out.append((GRAPH_NODE_KINDS.get(kind.value, f"type {kind.value}"), label))
    del graph
    return out


def graph_text(nodes: list[tuple[str, str]]) -> str:
    return "; ".join(kind + (f" {name[:60]}" if name else "") for kind, name in nodes)


def check_one_scan(label: str, fn, wrapper) -> list[tuple[str, str]]:
    """One call of ``fn`` enqueues one kernel, ``wrapper``'s (one launch of its
    count, an ``ivf_tma_kernel`` where the driver names it), and memsets:
    checked on the call's CUDA graph."""
    before = wrapper.launches
    nodes = graph_nodes(fn)
    kernels = [name for kind, name in nodes if kind == "kernel"]
    check(wrapper.launches - before == 1 and len(kernels) == 1
          and all(kind in ("kernel", "memset") for kind, _ in nodes)
          and (not kernels[0] or "ivf_tma_kernel" in kernels[0]),
          f"{label}: one call enqueued {nodes} ({wrapper.launches - before} launches)")
    return nodes


SCAN_KERNELS = ("topk_scan_kernel", "ivf_tma_kernel")


def search_split(fn, calls: int = 5) -> dict[str, float]:
    """Device time per call of ``fn`` (one whole index.search) by part
    (torch.profiler): the scan and merge kernels, the copies, and the rest
    (probe planning: the centroid product, sort, union and argsort), whose
    largest kernels are named. Returns the parts (ms)."""
    parts = dict.fromkeys(("planning and the rest", "scan", "merge", "copies"), 0.0)
    rest = []
    for name, (count, us) in device_kernels(fn, calls).items():
        part = ("scan" if any(k in name for k in SCAN_KERNELS)
                else "merge" if "topk_merge_kernel" in name
                else "copies" if "memcpy" in name.lower() or "memset" in name.lower()
                else "planning and the rest")
        parts[part] += us / calls / 1e3
        if part == "planning and the rest":
            rest.append((us / calls / 1e3, count // calls, name))
    print("  search device time per call: " + "; ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
          + f"; total {sum(parts.values()):.4f} ms")
    print(f"  planning and the rest: {sum(c for _, c, _ in rest)} kernels per call; largest: "
          + "; ".join(f"{n.replace('(anonymous namespace)::', '').split('(')[0][:60]} x{c} "
                      f"{ms:.4f} ms" for ms, c, n in sorted(rest, reverse=True)[:5]))
    return parts


def ivf_bound(tier: str, part: str, n_valid: int, br: int, d: int, qn: int, k: int):
    """The probed rows' bytes (vectors, bias, scales) and the queries and
    results, at the HBM rate; their 2·q·rows·d operations at the peak of
    their type. Returns (ms, "bytes" or "operations")."""
    rows = n_valid * br
    row_bytes = {"bfloat16": 2 * d + 4, "int8": d + 8, "int4": d // 2 + 8}[tier]
    bytes_ms = (rows * row_bytes + qn * d * 4 + qn * k * 8) / HBM_PEAK[part] * 1e3
    peak = BF16_PEAK[part] if tier == "bfloat16" else INT8_PEAK[part]
    ops_ms = 2 * qn * rows * d / peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def full_size_ivf(seed: int, part: str) -> tuple[dict[str, dict], dict[str, dict]]:
    """Returns (each tier's results, with its recall@10, and under "data"
    the clustered rows, queries and indexes, which phase 5f reuses; the bf16 and int8
    indexes' device tensors, queries and adaptive plans, which phase 5d
    reuses)."""
    from youtu_rag_tpu_torch.core.config import IndexConfig
    from youtu_rag_tpu_torch.core.types import Chunk
    from youtu_rag_tpu_torch.index.device_index import DeviceVectorIndex
    from youtu_rag_tpu_torch.index.ivf import plan_max_blocks, probe_blocks

    rows, d, qn, top_k, batch = ROWS, 768, 8, 10, 65536
    t0 = time.perf_counter()
    vecs, queries = clustered_rows(seed, rows, d, qn)
    queries[0] = vecs[rows // 3]  # a stored row: top-1 known
    out: dict = {"data": {"vecs": vecs, "queries": queries}}
    qpad = queries / np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
    qdev = torch.from_numpy(qpad).cuda()  # as search() prepares them
    chunks = [Chunk(f"c{i}", f"doc{i // 64}", "", i % 64) for i in range(rows)]
    print(f"IVF full size: {rows} x {d} clustered unit vectors made in "
          f"{time.perf_counter() - t0:.1f} s")
    keep = {}
    for tier in TIERS:
        kernel, plain, _ = ivf_ops()[tier]
        brute = ops()[tier][0]
        index = DeviceVectorIndex(d, IndexConfig(kind="ivf", storage_dtype=tier, **IVF_SETTINGS),
                                  device="cuda")
        index.reserve(rows)
        for start in range(0, rows, batch):
            index.add(chunks[start : start + batch], vecs[start : start + batch])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.build_ivf()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        st = index._ivf
        print(f"{tier}: build_ivf {build_s:.2f} s ({rows / build_s:.0f} rows/s), {st.n_lists} lists, "
              f"n_probe {st.n_probe}, at most {st.max_cluster_blocks} blocks per cluster")

        reset_launches()
        hits = index.search(queries, top_k=top_k)
        torch.cuda.synchronize()
        counts, brute_counts = ivf_counts(), launch_counts()
        check(counts[tier] > 0 and sum(counts.values()) == counts[tier],
              f"{tier}: index.search launched IVF kernels {counts}")
        check(sum(brute_counts.values()) == 0, f"{tier}: a brute launch {brute_counts} (no shadow)")
        check(len(hits) == qn and all(len(h) == top_k for h in hits), f"{tier}: wrong shape")
        check(all(np.isfinite(s) for h in hits for _, s in h), f"{tier}: non-finite scores")
        check(hits[0][0][0].id == f"c{rows // 3}", f"{tier}: query 0 top hit {hits[0][0][0].id}")

        # the search's own plan, the same device tensors, through the plain version
        x, b = index._vectors, index._bias
        extra = () if tier == "bfloat16" else (index._scales,)
        total = index.capacity // IVF_SETTINGS["block_rows"]

        def plan(margin):
            kw = {"adaptive_margin": margin, "min_probe": min(index.config.ivf_min_probe,
                                                              st.n_probe)} if margin else {}
            return probe_blocks(qdev, st.centroids, st.cluster_block_start, st.cluster_block_count,
                                n_probe=st.n_probe, max_cluster_blocks=st.max_cluster_blocks,
                                total_blocks=total, frozen_blocks=st.frozen_blocks,
                                max_blocks=plan_max_blocks(st, qn, total), **kw)

        ids, nv = plan(IVF_SETTINGS["ivf_adaptive_margin"])
        if tier != "int4":
            keep[tier] = {"q": qdev, "x": x, "extra": extra, "bias": b, "ids": ids, "nv": nv}
        k_kernel = top_k if tier != "int4" else 64  # int4: 4 x 10 candidates, pow2, re-ranked on the host
        call = lambda: kernel(qdev, x, *extra, b, ids, nv, k_kernel,  # noqa: E731
                              block_rows=IVF_SETTINGS["block_rows"])
        got = call()
        torch.cuda.synchronize()
        want = plain(qdev, x, *extra, b, ids, nv, k_kernel, block_rows=IVF_SETTINGS["block_rows"])
        full = plain_scores(qdev, x, b).cpu() if tier == "bfloat16" else None
        err = compare_ivf(tier, got, want, full, f"IVF {tier} full size")
        # the search's rows are this kernel call's (the kernel is deterministic)
        got_rows = np.asarray([[index._id_to_row[c.id] for c, _ in h] for h in hits])
        if tier == "int4":
            _, rr = index._host_rerank_candidates(qpad, got[0].cpu().numpy(), got[1].cpu().numpy(),
                                                  index._host_q8, index._host_s8, top_k)
            check(np.array_equal(got_rows, rr), "int4 IVF: the search's re-ranked rows differ")
        else:
            check(np.array_equal(got_rows, got[1][:, :top_k].cpu().numpy()),
                  f"{tier} IVF: the search's rows differ from its kernel's")
        brute_rows = brute(qdev, x, *extra, b, top_k)[1].cpu().numpy()
        ivf_rows = got[1][:, :top_k].cpu().numpy()
        recall = float(np.mean([len(set(a) & set(r)) / top_k for a, r in zip(ivf_rows, brute_rows)]))
        n_valid = int(nv)
        res = {"launches": counts[tier], "err": err, "recall": recall}
        out["data"].setdefault("index", {})[tier] = index  # 5f shards its rows
        print(f"  search matches the plain version on its plan; n_valid {n_valid} of {total} "
              f"blocks; recall@10 against {KERNEL_NAMES[tier]} {recall:.3f}")
        # what one call runs on the card: one kernel (the queries' prep and
        # the merge inside it) after a memset
        before = kernel.launches
        call()
        per_call = kernel.launches - before
        check(per_call == 1, f"{tier}: {per_call} launches per call")
        # what one call enqueues, from the driver (exact) ...
        nodes = check_one_scan(tier, call, kernel)
        # ... and what five ran by the profiler, which may lose some or all of
        # so short a window's records (kinds, not counts: every kind recorded
        # must be the scan or the memset)
        ran = device_kernels(call, 5)
        names = [n for n in ran if "memset" not in n.lower()]
        check(len(names) <= 1 and all("ivf_tma_kernel" in n for n in names),
              f"{tier}: five calls ran {sorted(ran)}")
        print(f"  one call: {per_call} launch; its CUDA graph: {graph_text(nodes)}; five calls "
              "on the card: " + ("; ".join(f"{n.split('(')[0][:60]} x{c}" for n, (c, _) in ran.items())
                                 or "the profiler recorded none"))

        for label, margin in (("adaptive", IVF_SETTINGS["ivf_adaptive_margin"]), ("fixed", 0.0)):
            if margin == 0.0:
                ids, nv = plan(0.0)
                n_valid = int(nv)
            ms = time_held_ms(call, cold=True)
            warm = time_ms(call)
            bms, by = ivf_bound(tier, part, n_valid, IVF_SETTINGS["block_rows"], d, qn, k_kernel)
            mb = n_valid * IVF_SETTINGS["block_rows"] * {"bfloat16": 2 * d + 4, "int8": d + 8,
                                                         "int4": d // 2 + 8}[tier] / 1e6
            earlier = (EARLIER_MS if label == "adaptive" else EARLIER_FIXED_MS).get(IVF_NAMES[tier])
            print(f"  {IVF_NAMES[tier]} {label} plan, n_valid {n_valid} ({mb:.1f} MB probed), "
                  f"k = {k_kernel}: {ms:.4f} ms device, L2 cold ({mb / ms:.1f} GB/s), 1 launch "
                  f"per call; {warm:.4f} ms per call back to back; bound {bms:.4f} ms ({by}); "
                  f"earlier design's recorded time {earlier} ms")
            if label == "adaptive":
                res.update(ms=ms, bound_ms=bms, bound_by=by)
                res["plain_ms"] = time_ms(lambda: plain(qdev, x, *extra, b, ids, nv, k_kernel,
                                                        block_rows=IVF_SETTINGS["block_rows"]),
                                          bursts=3, burst=5)
                brute_ms = time_ms(lambda: brute(qdev, x, *extra, b, k_kernel))
                print(f"  plain {res['plain_ms']:.4f} ms; brute {KERNEL_NAMES[tier]} on the same "
                      f"index {brute_ms:.4f} ms; library: none (no one PyTorch call computes a "
                      f"top-k over gathered blocks)")
            else:
                index.config.ivf_adaptive_margin = 0.0
            parts = search_split(lambda: index.search(queries, top_k=top_k))
            check(parts["merge"] == 0.0, f"{tier}: the search launched a merge kernel")
        out[tier] = res
        del index, x, b, extra, hits
        torch.cuda.empty_cache()
    return out, keep


# ---------------------------------------------------------------------------
# 5d. the ops path at full size, per-block
# ---------------------------------------------------------------------------


def blocks_bound(tier: str, part: str, rows: int, d: int, qn: int, n_blocks: int, k: int):
    """The brute per-block kernels' bound: the rows read (vectors, bias
    and, for int8, scales) and the queries, plus the candidates written
    (n_blocks × q × k_pad × 8 bytes), at the HBM rate; their 2·q·rows·d
    operations at the peak of their type (the merged IVF calls take
    ivf_bound: no candidates). Returns (ms, "bytes" or "operations")."""
    k_pad = -(-k // 128) * 128
    row_bytes = {"bfloat16": 2 * d + 4, "int8": d + 8}[tier]
    nbytes = rows * row_bytes + qn * d * 4 + n_blocks * qn * k_pad * 8
    bytes_ms = nbytes / HBM_PEAK[part] * 1e3
    peak = BF16_PEAK[part] if tier == "bfloat16" else INT8_PEAK[part]
    ops_ms = 2 * qn * rows * d / peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def ops_full_size(part: str, brute: dict, ivf: dict) -> dict[str, dict]:
    """5d: the per-block kernels through the ops API on phase 5's and 5c's
    device tensors (q = 8, k = 10)."""
    from youtu_rag_tpu_torch.ops.topk import NEG_INF, fused_topk, merge_blocks

    k, d = 10, 768
    kernels = blocks_ops()
    pruned = {tier: ops()[tier][0] for tier in ("bfloat16", "int8")}
    dma = {tier: ivf_ops()[tier][0] for tier in ("bfloat16", "int8")}
    # name → (tensors, block_rows)
    setup = {
        "topk": (brute["bfloat16"], 1024),
        "topk_int8": (brute["int8"], 2048),
        "ivf_topk": (ivf["bfloat16"], IVF_SETTINGS["block_rows"]),
        "ivf_topk_int8": (ivf["int8"], IVF_SETTINGS["block_rows"]),
    }

    def args(name):
        t, _ = setup[name]
        plan = (t["ids"], t["nv"]) if "ids" in t else ()
        return (t["q"], t["x"], *t["extra"], t["bias"], *plan, k)

    reset_launches()
    results = {"topk": fused_topk(*args("topk")[:3], k)}  # backend "auto"
    for name in BLOCKS_NAMES[1:]:
        results[name] = kernels[name][0](*args(name), block_rows=setup[name][1])
    torch.cuda.synchronize()
    counts = blocks_counts()
    print(f"ops path: fused_topk (auto), topk_int8, ivf_topk, ivf_topk_int8 at q = 8, k = {k}; "
          f"launches {counts}")
    check(all(counts[name] == 1 for name in BLOCKS_NAMES), f"ops path launches {counts}")

    out = {}
    for name, (kernel, plain, tier, takes_plan) in kernels.items():
        t, br = setup[name]
        a = args(name)
        x, b, q = t["x"], t["bias"], t["q"]
        rows = x.shape[0]
        full = plain_scores(q, x, b).cpu() if tier == "bfloat16" else None
        cand = kernel(*a, block_rows=br, candidates=True)
        torch.cuda.synchronize()
        err = compare_blocks(tier, cand, plain(*a, block_rows=br, candidates=True), full,
                             f"{name} full size candidates")
        got = results[name]
        err = max(err, compare_blocks(tier, got, plain(*a, block_rows=br), full,
                                      f"{name} full size"))
        # the pruned (brute) or DMA (IVF) kernel on the same tensors: the same live rows
        other = (dma[tier](*a, block_rows=br) if takes_plan else pruned[tier](*a))
        torch.cuda.synchronize()
        live = got[0] > NEG_INF / 2
        what = f"{name}: the live slots against the {'DMA' if takes_plan else 'pruned'} kernel's"
        if tier == "bfloat16":
            # the merged bf16 call sums on the tensor cores, in another order
            compare_topk(got, other, full, what)
        else:
            check(torch.equal(live, other[0] > NEG_INF / 2)
                  and torch.equal(got[1][live], other[1][live])
                  and torch.equal(got[0][live].view(torch.int32), other[0][live].view(torch.int32)),
                  f"{what} differ")
        plain_ms = time_ms(lambda: plain(*a, block_rows=br), bursts=3, burst=5)
        t0 = time.perf_counter()
        # the merged call is one kernel (csrc/ivf_scan_tma.cuh) after a
        # memset: no candidates, no sort. The host issues no torch.sort ...
        sort = torch.sort
        torch.sort = lambda *_, **__: check(False, f"{name}: the merged call sorts")
        try:
            kernel(*a, block_rows=br)
        finally:
            torch.sort = sort
        # ... and what the card ran (the profiler may drop events of so
        # short a window: kinds, not counts; every kind recorded must be
        # the scan or the memset)
        ran = device_kernels(lambda: kernel(*a, block_rows=br), 5)
        names = [kn for kn in ran if "memset" not in kn.lower()]
        check(len(names) <= 1 and all("ivf_tma_kernel" in kn for kn in names),
              f"{name}: five merged calls ran {sorted(ran)}")
        # (the driver's view of one call, which the profiler may not give)
        nodes = check_one_scan(f"{name} merged", lambda: kernel(*a, block_rows=br), kernel)
        ms = time_held_ms(lambda: kernel(*a, block_rows=br), cold=True)
        cand_ms = time_held_ms(lambda: kernel(*a, block_rows=br, candidates=True), cold=True)
        earlier_ms = time_held_ms(
            lambda: merge_blocks(*kernel(*a, block_rows=br, candidates=True), k), cold=True)
        ran_text = ("; ".join(f"{kn.split('(')[0][:60]} x{c}" for kn, (c, _) in ran.items())
                    or "no device event recorded")
        if takes_plan:
            n_valid = int(t["nv"])
            dma_ms = time_held_ms(lambda: dma[tier](*a, block_rows=br), cold=True)
            bms, by = ivf_bound(tier, part, n_valid, br, d, q.shape[0], k)
            print(f"  {name} {rows}x{d} block_rows={br}, n_valid {n_valid} of "
                  f"{t['ids'].numel()} listed blocks, q = {q.shape[0]}, k = {k}: merged call "
                  f"{ms:.4f} ms (one kernel, L2 cold), bound {bms:.4f} ms ({by}); earlier "
                  f"design (csrc/topk_blocks.cu candidates + merge_blocks) {earlier_ms:.4f} ms, "
                  f"its kernel alone {cand_ms:.4f} ms; {IVF_NAMES[tier]} (DMA kernel, same "
                  f"plan) {dma_ms:.4f} ms; plain {plain_ms:.4f} ms; library null [none: no one "
                  f"PyTorch call takes a top-k over gathered blocks]; five calls on the card: "
                  f"{ran_text}; max_abs_err {err}")
            library_ms = None
        else:
            other_ms = time_ms(lambda: pruned[tier](*a))
            desc, lib = library_call(tier, q, x, *(t["extra"] or (None,)), b, k)
            library_ms = None if lib is None else time_ms(lib)
            # rows, bias (and scales) read once and [q, k] written: phase 5's bound
            bms, by = bound(tier, part, rows, d, q.shape[0], k)
            print(f"  {name} {rows}x{d} block_rows={br}, q = {q.shape[0]}, k = {k}: merged call "
                  f"{ms:.4f} ms (one kernel, L2 cold), bound {bms:.4f} ms ({by}); earlier "
                  f"design (csrc/topk_blocks.cu candidates + merge_blocks: kernel + merge) "
                  f"{earlier_ms:.4f} ms, its kernel alone {cand_ms:.4f} ms; plain "
                  f"{plain_ms:.4f} ms; library "
                  f"{'null' if lib is None else format(library_ms, '.4f') + ' ms'} [{desc}]; "
                  f"{KERNEL_NAMES[tier]} {other_ms:.4f} ms; one call's graph: {graph_text(nodes)}; "
                  f"five calls on the card: {ran_text}; max_abs_err {err}")
        print(f"  ({name}: the merged call's gates and timings {time.perf_counter() - t0:.2f} s)")
        out[name] = {"launches": counts[name], "err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by, "library_ms": library_ms}
    return out


# ---------------------------------------------------------------------------
# 5f. main path, full size, sharded over a mesh
# ---------------------------------------------------------------------------

SHARDS = 4  # one card holds the 4 shards of a local mesh
GROUP_ROWS = 1 << 18  # (e): the index over a process group of one
GROWTH_ROWS = (3_000, 4_000, 6_000)  # (c): from 4,096 rows of capacity past two doublings
GROWTH_D = 256
TP_NEW = 32  # (f): greedy tokens
TP_PROMPT = 512
TP_STEPS = 16  # (f): decode steps timed


def hit_lists(hits) -> list[list[tuple[str, float]]]:
    return [[(c.id, float(s)) for c, s in h] for h in hits]


def same_lists(got, want, tol: float) -> bool:
    """``same_up_to_ties`` on (id, score) lists: ``tol`` 0 asks for the same
    ids and bit-equal scores."""
    if tol == 0.0:
        return got == want
    ns = types.SimpleNamespace
    return all(same_up_to_ties([ns(chunk=ns(id=i), score=s) for i, s in g],
                               [ns(chunk=ns(id=i), score=s) for i, s in w], tol)
               for g, w in zip(got, want, strict=True))


def mesh_of(n: int):
    """A local mesh of ``n`` shards, all on the card."""
    from youtu_rag_tpu_torch.parallel import get_mesh

    return get_mesh({"db": n}, devices=["cuda"] * n)


def fill(index, chunks, vecs, batch: int = 65536) -> float:
    index.reserve(len(chunks))
    t0 = time.perf_counter()
    for start in range(0, len(chunks), batch):
        index.add(chunks[start : start + batch], vecs[start : start + batch])
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def shard_parts(kernel, qdev, x, extra, b, k: int, n: int):
    """Each shard's kernel result with its rows made global (the merge's input)."""
    rows = x.shape[0] // n
    parts = []
    for j in range(n):
        sl = slice(j * rows, (j + 1) * rows)
        s, i = kernel(qdev, x[sl], *[e[sl] for e in extra], b[sl], k)
        parts.append((s, i + j * rows))
    return parts


def adopt(index, mesh, config=None):
    """A ShardedVectorIndex over ``mesh`` (and ``config``, by default
    ``index``'s) that holds ``index``'s rows as they are: a local mesh's
    shards are views of one [capacity, d] tensor, so it takes the same
    tensors and host state (no copy, no fill; phase 5's and 5c's indexes
    are filled once). Its IVF state is not taken."""
    from youtu_rag_tpu_torch.parallel import ShardedVectorIndex

    sharded = ShardedVectorIndex(index.dim, config or index.config, mesh=mesh)
    for name in ("capacity", "size", "live_count", "schema", "_vectors", "_cols", "_bias",
                 "_scales", "_host_q8", "_host_s8", "_chunks", "_id_to_row", "_doc_rows"):
        setattr(sharded, name, getattr(index, name))
    return sharded


def device_ms(fn, calls: int = 10, part=lambda name: False) -> tuple[float, float]:
    """(device ms of one call of ``fn``, of it the kernels ``part`` names),
    by torch.profiler: the sum of the call's kernels, whatever the host's
    enqueue gaps between them."""
    kernels = device_kernels(fn, calls)
    total = sum(us for _, us in kernels.values()) / calls / 1e3
    return total, sum(us for name, (_, us) in kernels.items() if part(name)) / calls / 1e3


def sharded_brute(part: str, smi: str, prev: dict) -> dict:
    """5f (a): phase 5's 1,048,576 x 768 index of each tier seen as 4 shards
    on the card (``adopt``): the unsharded index's hits (phase 5's), 4
    launches a search; a search's device time (4 kernels and the merge)
    beside one kernel over every row, its bound, and the merge's share."""
    rows, d, top_k = ROWS, 768, 10
    queries = prev["queries"]
    qn = queries.shape[0]
    qdev = torch.from_numpy(queries / np.linalg.norm(queries, axis=1, keepdims=True)).cuda()
    mesh = mesh_of(SHARDS)
    out: dict = {"launches": {}}
    for tier in TIERS:
        kernel = ops()[tier][0]
        index = adopt(prev["index"].pop(tier), mesh)
        reset_launches()
        hits = index.search(queries, top_k=top_k)
        torch.cuda.synchronize()
        counts = launch_counts()
        name = KERNEL_NAMES[tier]
        check(counts[tier] == SHARDS and sum(counts.values()) == SHARDS,
              f"5f (a) {tier}: one search launched {counts}, not {SHARDS} {name}")
        out["launches"][name] = counts[tier]
        got, want = hit_lists(hits), prev["hits"][tier]
        check(all(len(h) == top_k for h in got), f"5f (a) {tier}: short hit lists")
        check(same_lists(got, want, TOL if tier == "bfloat16" else 0.0),
              f"5f (a) {tier}: the sharded hits {got[:2]} differ from the unsharded {want[:2]}")
        # device time: the sharded search's kernels and merge, the merge
        # alone, one kernel over every row
        x, b = index._vectors, index._bias
        extra = () if tier == "bfloat16" else (index._scales,)
        k = top_k if tier != "int4" else 64  # int4: the re-rank's candidates
        sharded_ms, scan_ms = device_ms(lambda: index._run_brute(qdev, x, index._scales, b, k),
                                        part=lambda n: any(s in n for s in SCAN_KERNELS))
        parts = shard_parts(kernel, qdev, x, extra, b, k, SHARDS)
        merge_ms, _ = device_ms(lambda: index._layout.merge(parts, k))
        one_ms, _ = device_ms(lambda: kernel(qdev, x, *extra, b, k))
        bms, by = bound(tier, part, rows, d, qn, k)
        out[tier] = {"ms": sharded_ms, "scan_ms": scan_ms, "merge_ms": merge_ms,
                     "unsharded_ms": one_ms, "bound_ms": bms}
        print(f"5f (a) {tier}: hits = the unsharded index's; {counts[tier]} {name} launches a "
              f"search; a search's device time {sharded_ms:.4f} ms (k = {k}; the {SHARDS} scans "
              f"{scan_ms:.4f} ms; the merge alone {merge_ms:.4f} ms, "
              f"{merge_ms / sharded_ms * 100 if sharded_ms else float('nan'):.1f} %) against "
              f"one call over every row "
              f"{one_ms:.4f} ms and a bound of {bms:.4f} ms ({by}) [{smi}]")
        del index, x, b, extra, parts, hits
        torch.cuda.empty_cache()
    return out


def sharded_ivf(part: str, smi: str, prev: dict) -> dict:
    """5f (b): configs/rag/ivf_int8.yaml's index (read through the config
    loader) over phase 5c's clustered rows (its index of each tier seen as
    4 shards, ``adopt``), IVF built over the shards, filtered and not:
    every filtered hit passes the filter, the DMA kernel launches once per
    shard a search, recall@10 against the sharded brute search within 0.02
    of the unsharded IVF's (phase 5c's)."""
    from youtu_rag_tpu_torch.core.loader import ConfigLoader

    icfg = ConfigLoader().load_rag_config("ivf_int8").vector_store.index
    check({k: getattr(icfg, k) for k in IVF_SETTINGS} == IVF_SETTINGS,
          f"5f (b): configs/rag/ivf_int8.yaml says {icfg}, phases 5c and 5d copy {IVF_SETTINGS}")
    rows, top_k = ROWS, 10
    queries = prev["queries"]
    qdev = torch.from_numpy(queries / np.linalg.norm(queries, axis=1, keepdims=True)).cuda()
    mesh = mesh_of(SHARDS)
    out: dict = {"launches": {}}
    for tier in TIERS:
        # the yaml's config (5c's own index has since run with the margin off)
        index = adopt(prev["index"].pop(tier), mesh, icfg.model_copy(update={"storage_dtype": tier}))
        # every 8th row a part; the filter asks for part 0 (rows without one fail it)
        ids = [f"c{i}" for i in range(0, rows, 8)]
        t0 = time.perf_counter()
        index.update_metadata(ids, [{"part": i % 4} for i in range(len(ids))])
        t1 = time.perf_counter()
        index.build_ivf()
        torch.cuda.synchronize()
        meta_s, build_s = t1 - t0, time.perf_counter() - t1
        name, launches = IVF_NAMES[tier], 0
        for filters in (None, {"part": 0}):
            reset_launches()
            hits = index.search(queries, top_k=top_k, filters=filters)
            torch.cuda.synchronize()
            counts, brute = ivf_counts(), launch_counts()
            check(counts[tier] == SHARDS and sum(counts.values()) == SHARDS
                  and sum(brute.values()) == 0,
                  f"5f (b) {tier}: a search launched {counts} and brute {brute}, not {SHARDS} {name}")
            launches += counts[tier]
            check(all(len(h) == top_k for h in hits), f"5f (b) {tier}: short hit lists")
            if filters:
                check(all((c.metadata or {}).get("part") == 0 for h in hits for c, _ in h),
                      f"5f (b) {tier}: a filtered hit fails the filter")
            else:
                check(hits[0][0][0].id == f"c{rows // 3}", f"5f (b) {tier}: query 0's top hit")
        out["launches"][name] = launches
        # recall@10 as 5c measures it: the kernel's rows against the brute kernel's
        x, b, sc = index._vectors, index._bias, index._scales
        k = top_k if tier != "int4" else 64
        ivf_rows = index._run_sharded_ivf(qdev, x, sc, b, k)[1][:, :top_k].cpu().numpy()
        brute_rows = index._run_brute(qdev, x, sc, b, top_k)[1].cpu().numpy()
        recall = float(np.mean([len(set(a) & set(r)) / top_k
                                for a, r in zip(ivf_rows, brute_rows)]))
        base = prev["recall"][tier]
        check(recall >= base - 0.02,
              f"5f (b) {tier}: recall@10 {recall:.3f} against the unsharded IVF's {base}")
        ms, scan_ms = device_ms(lambda: index._run_sharded_ivf(qdev, x, sc, b, k),
                                part=lambda n: "ivf_tma_kernel" in n)
        out[tier] = {"recall": recall, "ms": ms, "scan_ms": scan_ms}
        print(f"5f (b) {tier}: 5c's index as {SHARDS} shards, its chunks' metadata set in "
              f"{meta_s:.1f} s, build_ivf {build_s:.2f} s; {SHARDS} {name} launches a search, "
              f"filtered or not, every filtered hit of part 0; recall@10 against the sharded "
              f"brute search {recall:.3f} (unsharded IVF, 5c: {base:.3f}); a search's device time "
              f"{ms:.4f} ms (k = {k}; the {SHARDS} scans {scan_ms:.4f} ms, the {SHARDS} plans and "
              f"the merge the rest) [{smi}]")
        del index, x, b, sc
        torch.cuda.empty_cache()
    return out


def sharded_maintenance(seed: int, smi: str) -> dict:
    """5f (c): appends past two capacity doublings, deletes, compact() and a
    snapshot reloaded with load_index(mesh=...), on 4 shards and against an
    unsharded twin, bf16 and int8: the twin's hits after every step."""
    from youtu_rag_tpu_torch.core.config import IndexConfig
    from youtu_rag_tpu_torch.core.types import Chunk
    from youtu_rag_tpu_torch.index.device_index import DeviceVectorIndex
    from youtu_rag_tpu_torch.index.persistence import load_index, save_index
    from youtu_rag_tpu_torch.parallel import ShardedVectorIndex

    d = GROWTH_D
    g = torch.Generator(device="cuda").manual_seed(seed + 50)
    mesh = mesh_of(SHARDS)
    launches = {}
    for tier in ("bfloat16", "int8"):
        cfg = IndexConfig(storage_dtype=tier, min_capacity=4096, auto_compact_ratio=0.0)
        sharded = ShardedVectorIndex(d, cfg, mesh=mesh)
        twin = DeviceVectorIndex(d, cfg, device="cuda")
        tol = TOL if tier == "bfloat16" else 0.0
        caps, n, steps = [sharded.capacity], 0, 0
        q, searches, main = None, 0, 0

        def compare(what, index=sharded, ref=twin):
            # the sharded search's launches alone: the twin's compare it
            nonlocal searches, main
            reset_launches()
            got = hit_lists(index.search(q, top_k=10))
            counts = launch_counts()
            searches, main = searches + 1, main + counts[tier]
            check(counts[tier] == SHARDS and sum(counts.values()) == SHARDS,
                  f"5f (c) {tier} {what}: a search launched {counts}, not {SHARDS}")
            want = hit_lists(ref.search(q, top_k=10))
            check(same_lists(got, want, tol), f"5f (c) {tier} {what}: {got[0]} != {want[0]}")

        for m in GROWTH_ROWS:
            v = torch.randn(m, d, generator=g, device="cuda")
            v = (v / v.norm(dim=1, keepdim=True)).cpu().numpy()
            chunks = [Chunk(f"r{n + i}", f"doc{(n + i) // 16}", "", i % 16) for i in range(m)]
            sharded.add(chunks, v)
            twin.add(chunks, v)
            n += m
            caps.append(sharded.capacity)
            q = np.concatenate([v[:4], np.random.default_rng(seed + n).standard_normal(
                (4, d)).astype(np.float32)])
            compare(f"after {n} rows")
            steps += 1
        check(caps[-1] >= 4 * caps[0] and sharded.capacity == twin.capacity,
              f"5f (c) {tier}: capacities {caps} (twin {twin.capacity})")
        dead = [f"r{i}" for i in range(0, n, 3)]
        check(sharded.delete(dead) == twin.delete(dead) == len(dead), "5f (c): deletes")
        compare("after deletes")
        sharded.compact()
        twin.compact()
        check(sharded.size == twin.size == sharded.count(), "5f (c): compaction")
        compare("after compact()")
        with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
            save_index(sharded, os.path.join(root, "index"))
            save_index(twin, os.path.join(root, "twin"))
            again = load_index(os.path.join(root, "index"), mesh=mesh)
            twin_again = load_index(os.path.join(root, "twin"), device="cuda")
        check(isinstance(again, ShardedVectorIndex) and again.n_shards == SHARDS,
              f"5f (c): load_index(mesh=...) gave {type(again).__name__}")
        # a reload re-inserts the dequantized rows, so it meets the twin's reload
        compare("after a snapshot round trip", again, twin_again)
        torch.cuda.synchronize()
        check(main == SHARDS * searches, f"5f (c) {tier}: {main} launches for {searches} searches")
        launches[KERNEL_NAMES[tier]] = main
        print(f"5f (c) {tier}: {n} rows appended, capacity {' -> '.join(map(str, caps))}; "
              f"{len(dead)} deleted; compact(); a snapshot reloaded on the mesh: the unsharded "
              f"twin's hits after each of {steps + 3} steps; {main} launches for {searches} "
              f"searches")
        del sharded, twin, again, twin_again
    return {"launches": launches}


def sharded_kb(seed: int, smi: str, unsharded_kb) -> dict:
    """5f (d): ``ApiState(mesh=...)`` builds a KB from 512 of 4f's files on
    the hash provider (4 launches a search), each fact's document in its
    hybrid top 5, the dense lists the unsharded card KB's (4i's) up to
    near-ties; a restart reloads the snapshot onto the mesh; then the
    encoder provider on the same mesh at T = 256 takes the data-parallel
    embedder (dp 4). Its 4 slices share the card, so it runs one merged
    forward: this checks the padding to a multiple of dp and that forward,
    bit-equal to the undistributed embedder's; the split across devices is
    the CPU tests' (``test_dp_embedder_*``)."""
    from youtu_rag_tpu_torch.api.state import ApiState
    from youtu_rag_tpu_torch.core.config import EmbeddingConfig
    from youtu_rag_tpu_torch.ingest.processors import SourceTask
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.parallel import ShardedVectorIndex

    mesh = mesh_of(SHARDS)
    out = {"launches": {"topk_pruned": 0}}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        facts = write_ingest_corpus(root, seed, n_docs=API_DOCS)
        names = [name for name, _ in facts]
        asked = facts[:: API_DOCS // API_QUESTIONS][:API_QUESTIONS]
        data = os.path.join(root, "data")
        t0 = time.perf_counter()
        state = ApiState(data_dir=data, mesh=mesh)
        kb, report = api_build(state, root, names)
        torch.cuda.synchronize()
        check(isinstance(kb.store._index, ShardedVectorIndex) and kb.store._index.n_shards == SHARDS
              and report.processed == API_DOCS and report.failed == 0,
              f"5f (d): the mesh's KB {type(kb.store._index).__name__}: {report.summary()}")
        print(f"5f (d): ApiState(mesh={mesh}) built {report.total_chunks} chunks from "
              f"{API_DOCS} files in {time.perf_counter() - t0:.1f} s")
        reset_launches()
        dense = [asyncio.run(kb.search(q, top_k=5, similarity_threshold=0.0)) for _, q in asked]
        hybrid = [asyncio.run(kb.hybrid_retriever.retrieve(q, top_k=5, similarity_threshold=0.0))
                  for _, q in asked]
        torch.cuda.synchronize()
        n = launch_counts()["bfloat16"]
        check(n == 2 * API_QUESTIONS * SHARDS,
              f"5f (d): {n} topk_pruned launches for {2 * API_QUESTIONS} searches on {SHARDS} shards")
        missing = [name for (name, _), h in zip(asked, hybrid)
                   if name not in [r.chunk.document_id for r in h]]
        check(not missing, f"5f (d): facts not in their hybrid top 5: {missing}")
        for (_, q), got in zip(asked, dense):
            ref = asyncio.run(unsharded_kb.search(q, top_k=5, similarity_threshold=0.0))
            check(same_up_to_ties(got, ref, TOL), f"5f (d) {q!r}: the mesh's dense hits differ "
                  "from the unsharded KB's")
        kb.save(os.path.join(data, "snapshots", "api"))
        reset_launches()
        again = ApiState(data_dir=data, mesh=mesh).kbs.get("api")
        check(again is not None and isinstance(again.store._index, ShardedVectorIndex),
              "5f (d): the restart's KB is not sharded")
        for (_, q), before in zip(asked[:API_RESTORED], dense):
            got = asyncio.run(again.search(q, top_k=5, similarity_threshold=0.0))
            check([(h.chunk.id, h.score) for h in got] == [(h.chunk.id, h.score) for h in before],
                  f"5f (d) restored {q!r}: other hits")
        torch.cuda.synchronize()
        n += launch_counts()["bfloat16"]
        out["launches"]["topk_pruned"] = n

        # the encoder provider on the mesh: dp 4, its slices all on the card
        cfg = state.rag_config.model_copy(deep=True)
        cfg.knowledge_builder.embedding = EmbeddingConfig(provider="tpu")
        enc = state.get_or_create_kb("enc", cfg)
        check(isinstance(enc.embedder, TorchEmbedder) and enc.embedder._dp == SHARDS,
              f"5f (d): the encoder KB's embedder {type(enc.embedder).__name__}")
        files = names[:INGEST_ENC_DOCS // 4]
        tasks = [SourceTask(n_, "text", path=str(state.files.local_path("uploads", n_)))
                 for n_ in files]
        reset_launches()
        t0 = time.perf_counter()
        rep = asyncio.run(enc.build_sources(tasks))
        torch.cuda.synchronize()
        att = attention_counts()["blockwise_attention"]
        check(rep.processed == len(files) and att > 0 and att % 12 == 0,
              f"5f (d): the encoder build {rep.summary()}, {att} blockwise launches")
        out["launches"]["blockwise_attention"] = att
        texts = [c.content for c in list(enc.store.index.iter_live())[:61]]  # padded to 64
        one = TorchEmbedder(batch_size=enc.embedder.batch_size)  # undistributed, the card
        check(np.array_equal(enc.embedder.embed_batch(texts), one.embed_batch(texts)),
              "5f (d): the data-parallel embeddings differ from the undistributed embedder's")
        print(f"5f (d): {API_QUESTIONS} dense and {API_QUESTIONS} hybrid searches at {SHARDS} "
              f"launches each, the unsharded KB's lists; a restart reloaded the mesh's KB; the "
              f"encoder's dp-{SHARDS} embedder (one merged forward on the card) built "
              f"{rep.total_chunks} chunks of {len(files)} files in "
              f"{time.perf_counter() - t0:.1f} s ({att} blockwise launches); {len(texts)} texts "
              f"padded to a multiple of {SHARDS}, bit-equal to the undistributed embedder's "
              f"[{smi}]")
    return out


def group_of_one(smi: str, vecs: np.ndarray, queries: np.ndarray) -> dict:
    """5f (e): ``init_process_group("nccl", world_size=1)``, a group mesh of
    4 shards on it and a 262,144-row bf16 index over it (grown through the
    ring, whose ring has one place): the local mesh's hits. Collectives
    across cards need a machine with several."""
    import torch.distributed as dist

    from youtu_rag_tpu_torch.core.config import IndexConfig
    from youtu_rag_tpu_torch.core.types import Chunk
    from youtu_rag_tpu_torch.parallel import ShardedVectorIndex, get_mesh

    rows, d = GROUP_ROWS, vecs.shape[1]
    chunks = [Chunk(f"c{i}", f"doc{i // 64}", "", i % 64) for i in range(rows)]
    local = ShardedVectorIndex(d, IndexConfig(min_capacity=4096), mesh=mesh_of(SHARDS))
    fill(local, chunks, vecs[:rows])
    want = hit_lists(local.search(queries, top_k=10))
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = get_mesh({"db": SHARDS}, devices=["cuda"] * SHARDS)
        check(mesh.distributed and mesh.group(("db",)) is not None, f"5f (e): {mesh}")
        index = ShardedVectorIndex(d, IndexConfig(min_capacity=4096), mesh=mesh)
        fill_s = fill(index, chunks, vecs[:rows])
        reset_launches()
        got = hit_lists(index.search(queries, top_k=10))
        torch.cuda.synchronize()
        n = launch_counts()["bfloat16"]
        check(n == SHARDS, f"5f (e): {n} launches a search")
        check(got == want, f"5f (e): the group's hits {got[0]} != the local mesh's {want[0]}")
        print(f"5f (e): NCCL, world size 1: a group mesh of {SHARDS} shards, {rows} rows grown to "
              f"capacity {index.capacity} through the ring in {fill_s:.1f} s, {n} launches a "
              f"search, the hits of the local mesh, bit for bit [{smi}]")
    finally:
        dist.destroy_process_group()
    return {"launches": {"topk_pruned": n}}


def tp_decoding(seed: int, smi: str) -> dict:
    """5f (f): tp 2 on a local mesh (both shards on the card) at Qwen2-0.5B's
    widths, phase 6b's seeded weights: in f32 with TF32 off 32 greedy tokens
    from 2 prompts of 512 equal the replicated run's; in bf16 the first
    step's logits within 6b's 0.15 of the replicated run's; ms per decode
    step beside the replicated run's."""
    import dataclasses

    from youtu_rag_tpu_torch.models import decoder as td
    from youtu_rag_tpu_torch.models.convert import decoder_params_from_numpy
    from youtu_rag_tpu_torch.models.pretrained import load_pretrained_decoder
    from youtu_rag_tpu_torch.parallel import get_mesh

    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        write_qwen2_checkpoint(root, seed)
        tree, cfg = load_pretrained_decoder(root, max_len=2048)
    mesh = get_mesh({"tp": 2}, devices=["cuda"] * 2)
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    prompt = torch.randint(0, cfg.vocab_size, (2, TP_PROMPT), generator=g, device="cuda")
    pmask = torch.ones(2, TP_PROMPT, device="cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f32 = dataclasses.replace(cfg, dtype=torch.float32)
        params = decoder_params_from_numpy(tree, f32, "cuda")
        tpd = td.shard_decoder(params, f32, mesh)
        want, want_len = td.generate(params, prompt, pmask, f32, max_new_tokens=TP_NEW)
        got, got_len = td.tp_generate(tpd, prompt, pmask, max_new_tokens=TP_NEW)
        check(torch.equal(got, want) and torch.equal(got_len, want_len),
              f"5f (f): f32 TP tokens {got[0, :8].tolist()} != replicated {want[0, :8].tolist()}")
        del params, tpd
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    params = td.cast_params_for_serving(decoder_params_from_numpy(tree, cfg, "cuda"))
    del tree
    tpd = td.shard_decoder(params, cfg, mesh)
    cache, caches = td.init_cache(cfg, 2, TP_PROMPT + TP_STEPS, "cuda"), tpd.init_cache(
        2, TP_PROMPT + TP_STEPS)
    first, _ = td.prefill(params, prompt, pmask, cache, cfg)
    tp_first = td.tp_prefill(tpd, prompt, pmask, caches)
    err = float((tp_first - first).abs().max())
    check(err <= BF16_TOL, f"5f (f): bf16 TP first-step logits {err} from the replicated run's")
    attn = torch.cat([pmask, torch.zeros(2, TP_STEPS, device="cuda")], 1)
    pos = torch.full((2,), TP_PROMPT, dtype=torch.int32, device="cuda")
    tok = torch.argmax(first, -1).to(torch.int32)

    def steps(step) -> float:  # ms a step over TP_STEPS steps, host clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TP_STEPS):
            attn[:, TP_PROMPT + i] = 1.0
            step(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / TP_STEPS

    one_ms = steps(lambda i: td.decode_step(params, tok, TP_PROMPT + i, attn, pos + i, cache, cfg))
    tp_ms = steps(lambda i: td.tp_decode_step(tpd, tok, TP_PROMPT + i, attn, pos + i, caches))
    print(f"5f (f): tp 2 at Qwen2-0.5B widths ({cfg.n_layers} layers): f32 (TF32 off) "
          f"{TP_NEW} greedy tokens of 2 prompts of {TP_PROMPT} = the replicated run's; bf16 "
          f"first step within {err:.4f} (gate {BF16_TOL}); a decode step (B 2, bf16) "
          f"{tp_ms:.3f} ms on tp 2 against {one_ms:.3f} ms replicated, host clock [{smi}]")
    return {"tp_ms": tp_ms, "one_ms": one_ms, "err": err}


def sharded_main_path(seed: int, part: str, smi: str, full: dict, full_ivf: dict,
                      api_kb) -> dict:
    """5f: the serving path over a mesh, (a)-(f). Returns the main path's
    launches by kernel."""
    launches: dict[str, int] = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    t0 = time.perf_counter()
    brute = sharded_brute(part, smi, full["data"])
    add(brute["launches"])
    print(f"-- 5f (a): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    prev_ivf = {**full_ivf["data"], "recall": {t: full_ivf[t]["recall"] for t in TIERS}}
    add(sharded_ivf(part, smi, prev_ivf)["launches"])
    print(f"-- 5f (b): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    add(sharded_maintenance(seed, smi)["launches"])
    print(f"-- 5f (c): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    add(sharded_kb(seed, smi, api_kb)["launches"])
    print(f"-- 5f (d): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    add(group_of_one(smi, full["data"]["vecs"], full["data"]["queries"])["launches"])
    print(f"-- 5f (e): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    tp = tp_decoding(seed, smi)
    print(f"-- 5f (f): {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"5f launches: {launches}")
    return {"launches": launches, "brute": brute, "tp": tp}


# ---------------------------------------------------------------------------
# 5b. main path at full size, encoder
# ---------------------------------------------------------------------------


class LastCall:
    """Stands in for an attention wrapper in the encoder module and keeps
    the inputs of its last call (the kernel still counts its launches)."""

    def __init__(self, fn):
        self.fn, self.args = fn, None

    def __call__(self, q, k, v, bias):
        self.args = (q, k, v, bias)
        return self.fn(q, k, v, bias)


class LastCallOn(LastCall):
    """``LastCall`` in place of ``module.name`` for a ``with`` block."""

    def __init__(self, module, name: str):
        super().__init__(getattr(module, name))
        self.module, self.name = module, name

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def drive_capturing(embedder, texts: list[str], name: str):
    """``embedder.embed_batch(texts)`` with the launch counts set to 0 just
    before and read just after; returns (embeddings, counts, the last
    ``name`` call's inputs)."""
    import youtu_rag_tpu_torch.models.encoder as encoder

    spy = LastCall(getattr(encoder, name))
    setattr(encoder, name, spy)
    try:
        reset_launches()
        emb = embedder.embed_batch(texts)
        torch.cuda.synchronize()
        counts = attention_counts()
    finally:
        setattr(encoder, name, spy.fn)
    return emb, counts, spy.args


def attention_bound(part: str, b: int, h: int, t: int, hd: int) -> tuple[float, str]:
    """The larger of 4·B·H·T²·hd operations at the bf16 tensor-core peak
    and the bytes moved once (q, k, v read, the output written, bf16; the
    f32 bias read) at the HBM rate. Returns (ms, "bytes" or "operations")."""
    ops_ms = 4 * b * h * t * t * hd / BF16_PEAK[part] * 1e3
    bytes_ms = (4 * b * h * t * hd * 2 + b * t * 4) / HBM_PEAK[part] * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def time_attention(name: str, args, part: str) -> dict:
    """Check the kernel on the main path's tensors, then time it, its plain
    version and scaled_dot_product_attention with the additive mask. The
    kernel and SDPA by both timers: ``time_ms`` (bursts of back-to-back
    calls; the kernels line's ``ms`` and ``library_ms``) and
    ``time_held_ms`` (one call held behind a spin of the card: its device
    time alone)."""
    kernel, plain = attention_ops()[name]
    b, h, t, hd = args[0].shape
    err = compare_attention(kernel(*args), plain(*args), f"{name} on the main path's tensors")
    ms = time_ms(lambda: kernel(*args))
    held_ms = time_held_ms(lambda: kernel(*args))
    plain_ms = time_ms(lambda: plain(*args), bursts=3, burst=3, warmup=1)
    q, k, v, bias = args
    mask = bias.to(q.dtype)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask))
    library_held_ms = time_held_ms(lambda: sdpa(q, k, v, attn_mask=mask))
    bms, by = attention_bound(part, b, h, t, hd)
    tflops = 4 * b * h * t * t * hd / ms / 1e9
    print(f"  {name} [{b}, {h}, {t}, {hd}] {str(q.dtype)[6:]}: time_ms {ms:.4f} ms "
          f"({tflops:.1f} TFLOP/s), time_held_ms {held_ms:.4f} ms, bound {bms:.4f} ms ({by}); "
          f"plain {plain_ms:.4f} ms; library time_ms {library_ms:.4f} ms, time_held_ms "
          f"{library_held_ms:.4f} ms [scaled_dot_product_attention, additive mask]; "
          f"max_abs_err {err}")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bms, "bound_by": by}


def encoder_full_size(seed: int, part: str, embedder) -> dict[str, dict]:
    import dataclasses

    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.models.encoder import encode_tokens

    rng = np.random.default_rng(seed)
    words = np.array(FILLER + [w.strip(".,;?!#").lower() for t in TOPICS.values() for w in t.split()])
    cfg = embedder.cfg
    out = {}

    # the default encoder: 128 texts, 300 to 600 words (truncated to 512 tokens)
    texts = [" ".join(rng.choice(words, size=int(n))) for n in rng.integers(300, 600, 128)]
    embedder.embed_batch(texts[:8])  # warm-up
    t0 = time.perf_counter()
    emb, counts, args = drive_capturing(embedder, texts, "blockwise_attention")
    wall = time.perf_counter() - t0
    check(emb.shape == (128, cfg.embed_dim) and np.isfinite(emb).all(), "forward: bad embeddings")
    check(np.allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-3), "forward: not unit vectors")
    check(counts == {"blockwise_attention": cfg.n_layers, "flash_attention": 0,
                     "flash_attention_stats": 0}, f"forward at T = 512: launches {counts}")
    check(tuple(args[0].shape) == (128, cfg.n_heads, 512, cfg.head_dim), f"shape {args[0].shape}")
    ids, mask = embedder.tokenizer.batch(texts)
    ids_d, mask_d = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    fwd_ms = time_ms(lambda: encode_tokens(embedder.params, ids_d, mask_d, cfg),
                     bursts=3, burst=3, warmup=1)
    print(f"encoder forward B = 128, T = {ids.shape[1]}: {fwd_ms:.4f} ms device "
          f"({128 / fwd_ms * 1e3:.1f} embeddings/s); embed_batch wall {wall * 1e3:.1f} ms "
          f"({128 / wall:.1f} embeddings/s, host tokenization included); launches {counts}")
    profile_split(lambda: encode_tokens(embedder.params, ids_d, mask_d, cfg), calls=1, top=8)
    out["blockwise_attention"] = {"launches": counts["blockwise_attention"],
                                  **time_attention("blockwise_attention", args, part)}
    del args

    # the same encoder with max_len 8192: two 8000-word documents → T = 8192, flash
    long_cfg = dataclasses.replace(cfg, max_len=8192, attention_impl="pallas")
    long_emb = TorchEmbedder(config=long_cfg, params=embedder.params, device="cuda")
    docs = [" ".join(rng.choice(words, size=8000)) for _ in range(2)]
    emb, counts, args = drive_capturing(long_emb, docs, "flash_attention")
    check(emb.shape == (2, cfg.embed_dim) and np.isfinite(emb).all(), "long documents: bad embeddings")
    check(counts == {"blockwise_attention": 0, "flash_attention": cfg.n_layers,
                     "flash_attention_stats": 0}, f"forward at T = 8192: launches {counts}")
    check(args[0].shape[2] == 8192, f"flash shape {args[0].shape}")
    print(f"long documents, T = 8192, batch bucket {args[0].shape[0]}: launches {counts}")
    ids, mask = long_emb.tokenizer.batch(docs, max_length=8192, pad_to=8192)
    ids_d, mask_d = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    fwd_ms = time_ms(lambda: encode_tokens(long_emb.params, ids_d, mask_d, long_cfg),
                     bursts=3, burst=2, warmup=1)
    print(f"encoder forward B = 2, T = 8192: {fwd_ms:.4f} ms device "
          f"({2 / fwd_ms * 1e3:.2f} embeddings/s)")
    profile_split(lambda: encode_tokens(long_emb.params, ids_d, mask_d, long_cfg), calls=1, top=8)
    args = tuple(x[:2].contiguous() for x in args)  # the two documents: B = 2
    out["flash_attention"] = {"launches": counts["flash_attention"],
                              **time_attention("flash_attention", args, part)}
    return out


# ---------------------------------------------------------------------------
# 5e. main path at full size, the ring
# ---------------------------------------------------------------------------


class HopSpy:
    """Stands in for the hop kernel in the SP module and keeps the inputs
    of its last call (the kernel still counts its launches)."""

    def __init__(self, fn):
        self.fn, self.args = fn, None

    def __call__(self, q, k, v, bias):
        self.args = (q, k, v, bias)
        return self.fn(q, k, v, bias)


def stats_bound(part: str, b: int, h: int, t: int, t_kv: int, hd: int, elem: int):
    """The larger of 4·B·H·T·T_kv·hd operations at the bf16 tensor-core
    peak and the bytes of q, k, v (read once), the bias, and acc, m and l
    (written once) at the HBM rate. Returns (ms, "bytes" or "operations")."""
    ops_ms = 4 * b * h * t * t_kv * hd / BF16_PEAK[part] * 1e3
    nbytes = (b * h * (t + 2 * t_kv) * hd * elem + b * t_kv * 4
              + b * h * t * hd * 4 + 2 * b * h * t * 4)
    bytes_ms = nbytes / HBM_PEAK[part] * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def paired_docs(rng, words, n: int, size: int) -> list[str]:
    """n documents of ``size`` words in pairs: the second of each pair is
    the first with a tenth of its words redrawn, so each document's nearest
    neighbour is its twin."""
    docs = []
    for _ in range(n // 2):
        a = rng.choice(words, size=size)
        b = a.copy()
        swap = rng.choice(size, size=size // 10, replace=False)
        b[swap] = rng.choice(words, size=len(swap))
        docs += [" ".join(a), " ".join(b)]
    return docs


def nearest(emb: np.ndarray) -> list[int]:
    sim = emb @ emb.T
    np.fill_diagonal(sim, -np.inf)
    return sim.argmax(axis=1).tolist()


def ring_full_size(seed: int, part: str, embedder) -> dict:
    """5e: (i) the default encoder with sp_mesh=4 embeds 8 documents of
    ~3,500 words (T bucket 4096, Tl 1024), held to the unsharded forward at
    T = 4096 (blockwise), and in f32 at T = 2048; (ii) the hop kernel at
    [2, 12, 8192, 64] bf16 against 8192 keys (sp 4 over T = 32,768)."""
    import dataclasses

    import youtu_rag_tpu_torch.parallel.sequence_parallel as sp
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.models.encoder import encode_tokens
    from youtu_rag_tpu_torch.ops.attention import (
        flash_attention_stats,
        flash_attention_stats_reference,
    )

    rng = np.random.default_rng(seed + 5)
    words = np.array(FILLER + [w.strip(".,;?!#").lower() for t in TOPICS.values() for w in t.split()])
    cfg = embedder.cfg
    out = {}

    # (i) bf16, 8 documents → T bucket 4096, Tl 1024
    docs = paired_docs(rng, words, 8, 3500)
    embedder.embed_batch(docs[:2])  # warm-up
    spy = HopSpy(sp.flash_attention_stats)
    sp.flash_attention_stats = spy
    try:
        reset_launches()
        t0 = time.perf_counter()
        emb = embedder.embed_batch(docs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = attention_counts()
    finally:
        sp.flash_attention_stats = spy.fn
    n_hops = counts["flash_attention_stats"]
    check(emb.shape == (8, cfg.embed_dim) and np.isfinite(emb).all(), "ring: bad embeddings")
    check(n_hops == cfg.n_layers * 4 and counts["blockwise_attention"] == 0,
          f"ring forward: launches {counts}, want {cfg.n_layers * 4} hops")
    q, k, v, bias = spy.args
    check(tuple(q.shape) == (32, cfg.n_heads, 1024, cfg.head_dim), f"hop shape {tuple(q.shape)}")
    err = compare_stats(flash_attention_stats(q, k, v, bias),
                        flash_attention_stats_reference(q, k, v, bias),
                        "the hop kernel on the main path's tensors bfloat16")
    seqs = [embedder.tokenizer.encode(d, embedder._long_max) for d in docs]
    ids = np.zeros((8, 4096), np.int64)
    mask = np.zeros((8, 4096), np.float32)
    for j, s in enumerate(seqs):
        ids[j, : len(s)], mask[j, : len(s)] = s, 1.0
    ids_d, mask_d = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    fwd = sp.make_sp_encoder(cfg, 4)
    fwd_ms = time_ms(lambda: fwd(embedder.params, ids_d, mask_d), bursts=3, burst=2, warmup=1)
    print(f"ring forward, 8 documents of {min(map(len, seqs))}-{max(map(len, seqs))} tokens "
          f"(T = 4096, sp 4, Tl 1024): {fwd_ms:.4f} ms device ({8 / fwd_ms * 1e3:.2f} "
          f"embeddings/s); embed_batch wall {wall * 1e3:.1f} ms ({8 / wall:.2f} embeddings/s, "
          f"host tokenization included); launches {counts}")
    profile_split(lambda: fwd(embedder.params, ids_d, mask_d), calls=1, top=8)
    ref, _ = encode_tokens(embedder.params, ids_d, mask_d, cfg)
    ref = ref.cpu().numpy()
    diff = float(np.abs(emb - ref).max())
    near, near_ref = nearest(emb), nearest(ref)
    print(f"  against the unsharded forward at T = 4096 (blockwise): max |diff| {diff:.3g}, "
          f"top-1 neighbours {near} (unsharded {near_ref})")
    check(near == near_ref == [j ^ 1 for j in range(8)], "ring: top-1 neighbours differ")
    check(diff <= ENC_TOL, f"ring: embeddings differ from the unsharded forward by {diff}")
    # 6d (f) holds the ring with tensor parallelism to the same forward
    out.update(unsharded=(ids_d, mask_d, ref), ring_ms=fwd_ms)
    # f32 at T = 2048 (Tl 512): JAX's own test tolerance
    f32 = TorchEmbedder(config=dataclasses.replace(cfg, dtype=torch.float32),
                        params=embedder.params, device="cuda", sp_mesh=4)
    docs32 = paired_docs(rng, words, 2, 1900)
    seqs = [f32.tokenizer.encode(d, f32._long_max) for d in docs32]
    ids = np.zeros((2, 2048), np.int64)
    mask = np.zeros((2, 2048), np.float32)
    for j, s in enumerate(seqs):
        ids[j, : len(s)], mask[j, : len(s)] = s, 1.0
    before = attention_counts()["flash_attention_stats"]
    got32 = f32.embed_batch(docs32)
    torch.cuda.synchronize()
    n_hops += attention_counts()["flash_attention_stats"] - before
    ref32, _ = encode_tokens(f32.params, torch.from_numpy(ids).cuda(),
                             torch.from_numpy(mask).cuda(), f32.cfg)
    diff32 = float(np.abs(got32 - ref32.cpu().numpy()).max())
    print(f"  f32, 2 documents at T = 2048 (Tl 512): max |diff| {diff32:.3g} from the unsharded "
          "forward (blockwise, f32)")
    check(diff32 <= 2e-5, f"ring f32: embeddings differ by {diff32} > 2e-5")

    # (ii) one hop at [2, 12, 8192, 64] bf16 against 8192 keys
    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    b, h, t, hd = 2, cfg.n_heads, 8192, cfg.head_dim
    q, k, v = (torch.randn(b, h, t, hd, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    mask = torch.ones(b, t, device="cuda")
    mask[0, t // 2 + 3 :] = 0
    bias = (1.0 - mask) * -1e9
    args = (q, k, v, bias)
    err = max(err, compare_stats(flash_attention_stats(*args),
                                 flash_attention_stats_reference(*args),
                                 "hop [2, 12, 8192, 64] bfloat16"))
    ms = time_held_ms(lambda: flash_attention_stats(*args))
    plain_ms = time_held_ms(lambda: flash_attention_stats_reference(*args), calls=3, warmup=1)
    bms, by = stats_bound(part, b, h, t, t, hd, 2)
    library_ms, lib_desc = None, ""
    try:
        eff = torch.ops.aten._scaled_dot_product_efficient_attention
        lib_bias = bias.to(q.dtype)[:, None, None, :].expand(b, h, t, t)
        eff(q, k, v, lib_bias, True)
        library_ms = time_held_ms(lambda: eff(q, k, v, lib_bias, True))
        lib_desc = ("_scaled_dot_product_efficient_attention(..., compute_log_sumexp=True): "
                    "(out, logsumexp), the hop in normalized form")
    except (RuntimeError, TypeError) as e:
        lib_desc = ("none: the efficient-attention call refused these inputs "
                    f"({str(e).splitlines()[0][:160]})")
    tflops = 4 * b * h * t * t * hd / ms / 1e9
    print(f"  flash_attention_stats [{b}, {h}, {t}, {hd}] bf16 vs {t} keys: {ms:.4f} ms "
          f"({tflops:.1f} TFLOP/s), bound {bms:.4f} ms ({by}); plain {plain_ms:.4f} ms; library "
          f"{'null' if library_ms is None else format(library_ms, '.4f') + ' ms'} [{lib_desc}]; "
          f"the mma.sync kernel's recorded time {EARLIER_MS['flash_attention_stats']} ms; "
          f"max_abs_err {err}")
    out.update(launches=n_hops, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               library_ms=library_ms)
    return out


# ---------------------------------------------------------------------------
# 6. the local LLM on the card
# ---------------------------------------------------------------------------

CHAT_WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "benchmarks", "models", "yrt_tiny_chat")
# a copy of the chat model's training-data generator (the JAX package's
# models/lm_synth.py: pseudo-word entities, its attributes and templates)
CHAT_ATTRS = ("color", "mass", "code", "owner", "status", "price", "origin", "rank", "voltage",
              "length", "capacity", "model", "category", "weight")
CHAT_FACTS = ("The {attr} of {ent} is {val}.", "{ent} has a {attr} of {val}.",
              "For {ent}, the {attr} is {val}.")
CHAT_QUESTIONS = ("What is the {attr} of {ent}?", "what {attr} does {ent} have?",
                  "Tell me the {attr} of {ent}.")


def chat_word(rng, syllables: int) -> str:
    return "".join(rng.choice(list("bcdfgklmnprstvz")) + rng.choice(list("aeiou"))
                   for _ in range(syllables))


def write_fact_corpus(root: str, seed: int, n_docs: int = 12) -> list[tuple[str, str]]:
    """``n_docs`` fact documents of two or three facts each in the chat
    model's training format; returns for each document a question about
    its first fact and that fact."""
    rng = np.random.default_rng(seed)
    questions = []
    for i in range(n_docs):
        facts = []
        for j in range(int(rng.integers(2, 4))):
            ent = chat_word(rng, 2).capitalize()
            attr = str(rng.choice(CHAT_ATTRS))
            val = chat_word(rng, 2) if rng.random() < 0.5 else f"{int(rng.integers(2, 950))} kg"
            facts.append(str(rng.choice(CHAT_FACTS)).format(attr=attr, ent=ent, val=val))
            if j == 0:
                questions.append((str(rng.choice(CHAT_QUESTIONS)).format(attr=attr, ent=ent),
                                  facts[0]))
        with open(os.path.join(root, f"facts_{i:02d}.md"), "w") as f:
            f.write(" ".join(facts))
    return questions


def run_cli(argv: list[str], questions: list[str]) -> tuple[list[str], list[tuple], object]:
    """``python -m youtu_rag_tpu_torch.cli_chat`` in this process, the
    questions on its standard input. Returns the text printed for each, the
    tool calls its agent made as (name, arguments, the observation the
    model was given), and the agent's KB toolkit."""
    import contextlib
    import io

    from youtu_rag_tpu_torch import cli_chat
    from youtu_rag_tpu_torch.tools.base import ToolRouter

    calls, routers, call = [], [], ToolRouter.call

    async def recorded(router, name, arguments):
        out = await call(router, name, arguments)
        calls.append((name, arguments, out))
        routers.append(router)
        return out

    out, stdin = io.StringIO(), sys.stdin
    sys.stdin = io.StringIO("\n".join(questions) + "\n")
    ToolRouter.call = recorded
    try:
        with contextlib.redirect_stdout(out):
            asyncio.run(cli_chat.main(argv))
    finally:
        sys.stdin, ToolRouter.call = stdin, call
    blocks = [block.strip() for block in out.getvalue().split("\n> ")[1:-1]]
    return blocks, calls, routers[0].toolkits[0] if routers else None


def agentic_cli(seed: int) -> dict:
    """6a: the port's agentic CLI on yrt_tiny_chat over a fact corpus, on
    the card (the KB's search through topk_pruned, the decoder in bf16),
    then on the CPU. Gates: no turn reports an error; each question's first
    turn parses to a kb_embedding_search action; every observation the
    model was given is a search result (not an error, not empty); the
    search launched topk_pruned; a final answer comes back; and the same
    toolkit, asked each question itself, returns the fact document the
    question was made from."""
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        asked = write_fact_corpus(root, seed)[:3]
        questions = [q for q, _ in asked]
        argv = ["--paths", root, "--llm-weights-dir", CHAT_WEIGHTS]
        reset_launches()
        t0 = time.perf_counter()
        card, calls, toolkit = run_cli(argv, questions)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        t0 = time.perf_counter()
        cpu, cpu_calls, _ = run_cli(argv + ["--device", "cpu"], questions)
        cpu_wall = time.perf_counter() - t0
    check(len(card) == len(questions), f"6a: {len(card)} answers to {len(questions)} questions")
    for where, blocks in (("card", card), ("CPU", cpu)):
        for q, block in zip(questions, blocks):
            check("[error" not in block, f"6a: the {where} run reports an error for {q!r}: {block}")
    for q, block in zip(questions, card):
        print(f"  > {q}\n    " + block.replace("\n", "\n    "))
        check(block.startswith("[tool kb_embedding_search("),
              f"6a: the first turn for {q!r} is not a kb_embedding_search action")
        answer = block.split(")]", 1)[1].strip() if ")]" in block else ""
        check(bool(answer) and not answer.startswith("[tool"),
              f"6a: no final answer for {q!r}")
    check(len(calls) == sum(block.count("[tool ") for block in card),
          f"6a: {len(calls)} tool calls recorded against the transcript's")
    for name, arguments, obs in calls:
        check(name == "kb_embedding_search" and obs.startswith("[1] (score ")
              and not obs.startswith("Error"),
              f"6a: the observation of {name}({arguments}) is not a search result: {obs[:200]!r}")
    check(counts["bfloat16"] > 0, f"6a: the KB tool launched no topk_pruned: {counts}")
    # the same toolkit on the card, asked each question itself (not counted above)
    for q, fact in asked:
        obs = asyncio.run(toolkit.kb_embedding_search(q))
        check(not obs.startswith("Error") and fact in obs,
              f"6a: the search for {q!r} does not return its fact document: {obs[:300]!r}")
    print(f"  topk_pruned launches {counts['bfloat16']}; card run {wall:.1f} s, CPU run "
          f"{cpu_wall:.1f} s; {len(calls)} searches, each a result; each question's own search "
          f"returns its fact document; transcript equal to the CPU port's: {card == cpu}; "
          f"observations equal: {[c[2] for c in calls] == [c[2] for c in cpu_calls]}")
    return {"launches": counts["bfloat16"]}


# Qwen/Qwen2-0.5B-Instruct's config.json (random weights from the seed)
QWEN2_05B = {"model_type": "qwen2", "vocab_size": 151936, "hidden_size": 896,
             "num_hidden_layers": 24, "num_attention_heads": 14, "num_key_value_heads": 2,
             "intermediate_size": 4864, "max_position_embeddings": 32768, "rope_theta": 1000000.0,
             "rms_norm_eps": 1e-6, "tie_word_embeddings": True, "bos_token_id": 151643,
             "eos_token_id": 151645, "hidden_act": "silu", "torch_dtype": "bfloat16"}
# Gates of 6b, calibrated on an H100 at these widths and full depth by
# ``python -m youtu_rag_tpu_torch.bench.decoder_tolerance`` (seeds 0-5, the
# weights and tokens this phase draws; logit std 0.60): each lies between
# the largest sound reading and the smallest reading of the controls it
# catches. First step against the CPU f32 forward: sound 0.050-0.067;
# the residual stream in fp8 0.34-0.40, RoPE at base 1e4 0.77-1.30, the
# q/k/v biases dropped 1.47-1.84 (scores and softmax in bf16, 0.053-0.068,
# and logits in bf16, 0.050-0.066, are not told apart). Cached decode
# against the teacher-forced forward: sound 0.047-0.054; the cache read
# through fp8 0.108-0.154, positions one too far 0.27-0.37 (scores and
# softmax in bf16, 0.056-0.066, not told apart). int8 KV cache against
# the bf16 one: sound 0.063-0.079; a 4-bit quantizer 0.38-0.51
# (truncation, 0.079-0.096, not told apart).
BF16_TOL = 0.15
DECODE_TOL = 0.08
INT8_KV_TOL = 0.15


def write_qwen2_checkpoint(d: str, seed: int) -> int:
    """A qwen2-layout checkpoint directory (config.json, model.safetensors in
    BF16) with Qwen2-0.5B's widths: weights N(0, 0.02^2), q/k/v biases
    N(0, 0.02^2), norms 1, drawn on the card from ``seed``. Returns the
    parameter count."""
    c = QWEN2_05B
    dm, ff, kv = c["hidden_size"], c["intermediate_size"], (
        c["num_key_value_heads"] * c["hidden_size"] // c["num_attention_heads"])
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return (0.02 * torch.randn(shape, generator=g, device="cuda")).cpu().numpy()

    tensors = {"model.embed_tokens.weight": rand(c["vocab_size"], dm),
               "model.norm.weight": np.ones(dm, np.float32)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        tensors.update({
            p + "input_layernorm.weight": np.ones(dm, np.float32),
            p + "post_attention_layernorm.weight": np.ones(dm, np.float32),
            p + "self_attn.q_proj.weight": rand(dm, dm), p + "self_attn.q_proj.bias": rand(dm),
            p + "self_attn.k_proj.weight": rand(kv, dm), p + "self_attn.k_proj.bias": rand(kv),
            p + "self_attn.v_proj.weight": rand(kv, dm), p + "self_attn.v_proj.bias": rand(kv),
            p + "self_attn.o_proj.weight": rand(dm, dm),
            p + "mlp.gate_proj.weight": rand(ff, dm), p + "mlp.up_proj.weight": rand(ff, dm),
            p + "mlp.down_proj.weight": rand(dm, ff),
        })
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(c, f)
    write_safetensors(os.path.join(d, "model.safetensors"), tensors, "BF16")
    return sum(t.size for t in tensors.values())


def decode_split(step, wall_ms: float) -> dict[str, float]:
    """One decode step's device time by kind (torch.profiler, the operators
    that launched the kernels): the weight GEMMs (aten::mm), the attention
    einsums (aten::bmm), the rest (elementwise, norms, casts, cache
    writes); and the host's share, a step's wall time less its device
    time. ms each."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    ops, kernels = {"aten::mm": 0.0, "aten::bmm": 0.0}, 0.0
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = getattr(e, "cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            kernels += us if us is not None else getattr(e, "self_cuda_time_total", 0)
        elif e.key in ops:
            ops[e.key] += dev
    split = {"GEMMs": ops["aten::mm"] / 1e3, "attention einsums": ops["aten::bmm"] / 1e3}
    split["elementwise and the rest"] = max(kernels / 1e3 - sum(split.values()), 0.0)
    split["host (wall less device)"] = max(wall_ms - kernels / 1e3, 0.0)
    return split


def read_back_ms(logits: torch.Tensor, calls: int = 200, bursts: int = 5) -> float:
    """The host's cost of reading one flag back after a step, as generate
    reads ``done``: a reduction over ``logits`` [B, V] and its copy to the
    host, the step it follows already done (the device idle, as it is when
    the host is what bounds decode). Median over bursts, ms per read."""
    times = []
    for _ in range(bursts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            bool((logits[:, 0] > 1e30).all())
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    return statistics.median(times)


def qwen2_width(seed: int, part: str) -> dict:
    """6b: the Qwen2-0.5B-width checkpoint through load_pretrained_decoder
    (max_len 2048), served in bf16 on the card. Gates (tolerances above):
    decode with the cache against a prefill over the same sequence, the
    int8 KV cache against the bf16 one, the first step's logits against
    the CPU f32 forward at B = 1, T = 128. Prints prefill and decode times,
    the bytes bound, generate tokens/s and a decode step's split."""
    import dataclasses

    from youtu_rag_tpu_torch.models import decoder as td
    from youtu_rag_tpu_torch.models.convert import decoder_params_from_numpy
    from youtu_rag_tpu_torch.models.pretrained import load_pretrained_decoder

    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        t0 = time.perf_counter()
        n_params = write_qwen2_checkpoint(root, seed)
        t1 = time.perf_counter()
        tree, cfg = load_pretrained_decoder(root, max_len=2048)
        t2 = time.perf_counter()
    check(cfg.n_kv_heads == 2 and cfg.qkv_bias and cfg.tie_embeddings and cfg.max_len == 2048
          and cfg.dtype == torch.bfloat16, f"6b: the qwen2 config reads as {cfg}")
    params = td.cast_params_for_serving(decoder_params_from_numpy(tree, cfg, "cuda"))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    weight_bytes = sum(v.numel() * v.element_size() for v in params["layers"].values()) + \
        params["tok_emb"].numel() * params["tok_emb"].element_size() + \
        params["final_ln_scale"].numel() * 4
    print(f"  {n_params / 1e6:.1f} M parameters ({weight_bytes / 1e9:.3f} GB served): written in "
          f"{t1 - t0:.1f} s, loaded in {t2 - t1:.1f} s, on the card in {t3 - t2:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    out: dict = {}

    # the first step against the CPU f32 forward of the same checkpoint (B 1, T 128)
    toks = torch.randint(0, cfg.vocab_size, (1, 128), generator=g, device="cuda")
    mask = torch.ones(1, 128, device="cuda")
    card, _ = td.prefill(params, toks, mask, td.init_cache(cfg, 1, 128, "cuda"), cfg)
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = decoder_params_from_numpy(tree, f32)
    del tree
    t0 = time.perf_counter()
    ref, _ = td.prefill(cpu_params, toks.cpu(), mask.cpu(), td.init_cache(f32, 1, 128), f32)
    cpu_s = time.perf_counter() - t0
    del cpu_params
    err_f32 = float((card.float().cpu() - ref).abs().max())
    print(f"  first step, card bf16 vs CPU f32 (B 1, T 128, CPU {cpu_s:.1f} s): max "
          f"|diff| {err_f32:.4f} (logit std {float(ref.std()):.3f}); gate {BF16_TOL}")
    check(err_f32 <= BF16_TOL, f"6b: bf16 logits {err_f32} from the CPU f32 forward")

    # decode with the cache against the teacher-forced forward, bf16 and int8 caches
    seq = torch.randint(0, cfg.vocab_size, (2, 144), generator=g, device="cuda")
    full = td.causal_logits(params, seq, torch.ones(2, 144, device="cuda"), cfg)
    logits = {}
    for kv in ("native", "int8"):
        c = dataclasses.replace(cfg, kv_cache_dtype=kv)
        cache = td.init_cache(c, 2, 144, "cuda")
        lg, cache = td.prefill(params, seq[:, :128], torch.ones(2, 128, device="cuda"), cache, c)
        attn = torch.zeros(2, 144, device="cuda")
        attn[:, :128] = 1.0
        steps = [lg]
        for t in range(128, 144):
            attn[:, t] = 1.0
            lg, cache = td.decode_step(params, seq[:, t], t, attn,
                                       torch.full((2,), t, dtype=torch.int32, device="cuda"),
                                       cache, c)
            steps.append(lg)
        logits[kv] = torch.stack(steps, 1)  # positions 127 .. 143
    err_dec = float((logits["native"] - full[:, 127:]).abs().max())
    err_int8 = float((logits["int8"] - logits["native"]).abs().max())
    print(f"  decode with the cache vs the teacher-forced forward (17 positions): {err_dec:.4f} "
          f"(gate {DECODE_TOL}); int8 KV cache vs bf16: {err_int8:.4f} (gate {INT8_KV_TOL})")
    check(err_dec <= DECODE_TOL, f"6b: cached decode {err_dec} from the teacher-forced forward")
    check(err_int8 <= INT8_KV_TOL, f"6b: the int8 KV cache {err_int8} from the bf16 one")
    del full, logits

    # speed: prefill at T = 512, decode over 128 new tokens, B = 1 and 8
    tp, n_new = 512, 128
    for b in (1, 8):
        prompt = torch.randint(0, cfg.vocab_size, (b, tp), generator=g, device="cuda")
        pmask = torch.ones(b, tp, device="cuda")
        pre_cache = td.init_cache(cfg, b, tp, "cuda")
        pre_ms = time_held_ms(lambda: td.prefill(params, prompt, pmask, pre_cache, cfg), calls=5)
        del pre_cache
        print(f"  B {b}: prefill T {tp} {pre_ms:.3f} ms ({b * tp / pre_ms * 1e3:.0f} tokens/s)")
        out[f"prefill B {b}"] = pre_ms
        for kv in ("native", "int8"):
            c = dataclasses.replace(cfg, kv_cache_dtype=kv)
            cache = td.init_cache(c, b, tp + n_new, "cuda")
            first, cache = td.prefill(params, prompt, pmask, cache, c)
            attn = torch.cat([pmask, torch.zeros(b, n_new, device="cuda")], 1)
            pos = torch.full((b,), tp, dtype=torch.int32, device="cuda")

            def decode(i, lg):  # one greedy step into cache slot tp + i, no host sync
                attn[:, tp + i] = 1.0
                tok = torch.argmax(lg, -1).to(torch.int32)
                return td.decode_step(params, tok, tp + i, attn, pos + i, cache, c)[0]

            # ms per step over n_new steps, no read-back: host clock, CUDA events
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            lg = first
            t0 = time.perf_counter()
            e0.record()
            for i in range(n_new):
                lg = decode(i, lg)
            e1.record()
            e1.synchronize()
            wall_ms, dev_ms = (time.perf_counter() - t0) * 1e3 / n_new, e0.elapsed_time(e1) / n_new
            sync_ms = read_back_ms(lg) if kv == "native" else None
            held = time_held_ms(lambda: decode(n_new - 1, first), calls=10)
            # the bytes a step must read: the weights once, the valid cache once
            # (at the mean length tp + n_new / 2; int8 with its f32 scales)
            per_pos = cfg.head_dim * (1 if kv == "int8" else 2) + (4 if kv == "int8" else 0)
            kv_bytes = 2 * cfg.n_layers * b * cfg.n_kv_heads * (tp + n_new / 2) * per_pos
            bound = (weight_bytes + kv_bytes) / HBM_PEAK[part] * 1e3
            out[f"decode B {b} {kv}"] = {"ms_per_token": wall_ms, "device_ms": dev_ms,
                                         "held_ms": held, "bound_ms": bound}
            print(f"  B {b} {kv} KV cache: decode {wall_ms:.3f} ms per step (host clock, no "
                  f"sync; events {dev_ms:.3f} ms), one step held {held:.3f} ms; bytes bound "
                  f"{bound:.4f} ms ({(weight_bytes + kv_bytes) / 1e9:.3f} GB); "
                  f"{b / wall_ms * 1e3:.0f} tokens/s"
                  + ("" if sync_ms is None else
                     f"; generate's read-back of `done` alone, the step done: {sync_ms:.4f} ms"))
            if kv == "native":
                split = decode_split(lambda: decode(n_new - 1, first), wall_ms)
                print("    a decode step's split: " + "; ".join(
                    f"{k} {v:.3f} ms" for k, v in split.items()))
            del cache
        # generate: the prefill and the host loop, which reads `done` after each step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen, lengths = td.generate(params, prompt, pmask, cfg, max_new_tokens=n_new)
        gen_s = time.perf_counter() - t0
        check(tuple(gen.shape) == (b, n_new) and bool((lengths <= n_new).all()),
              "6b: generate's output")
        print(f"  B {b}: generate {n_new} new tokens in {gen_s:.3f} s, {b * n_new / gen_s:.0f} "
              f"tokens/s (lengths {sorted(set(lengths.tolist()))})")
        out[f"generate B {b}"] = b * n_new / gen_s
    return out



# ---------------------------------------------------------------------------
# 6c. training on the card
# ---------------------------------------------------------------------------

# 6c (a): train_embedder's run at the default EncoderConfig's widths:
# TRAIN_STEPS steps, 120, cut from 200 (0.18-0.22 s a step; the checkpoint
# at 100 and the resumed steps 101-105 stay), and 6c (d)'s train_chat_lm,
# CHAT_LM_STEPS, 100, cut from 200 (~0.21 s a step; its loss at 100 already
# 2.07 from 7.58), for the script's 1,200-s limit (a run before these cuts
# took 1,190 s on an NVIDIA H100 80GB HBM3, 700.00 W)
TRAIN_STEPS, CHAT_LM_STEPS = 120, 100
TRAIN_ARGS = ["--synthetic", "512", "--siblings", "4", "--paraphrase", "2048", "--batch", "64",
              "--seqlen", "128", "--steps", str(TRAIN_STEPS), "--ckpt-every", "100",
              "--warmup", "20"]
# One step's gradients on the card (f32, TF32 off) against a CPU f32 twin
# from the same parameters, B = 8, T = 64: each leaf within GRAD_RTOL of its
# largest CPU gradient. f32 sums in another order differ by ~1e-7 relative
# an operation; through 12 layers and the InfoNCE softmax at temperature
# 0.05 (logits x 20) the CPU parity tests see ~1e-6; a gradient that
# skipped a path (wq, wk, wv without one, as the kernels would leave them)
# is off by 100 %.
GRAD_RTOL = 1e-3
# A holdout query the KB answers otherwise than eval_recall is a near-tie
# if eval's margin between its positive and the best other positive is
# within TIE_TOL: the KB scores the bf16 rows of its index against a bf16
# query (two roundings of 2^-9 relative each, on scores of magnitude <= 1)
TIE_TOL = 8e-3
# The resumed steps 101-105 against the uninterrupted run's parameters
# after the same steps: each leaf within RESUME_RTOL of the largest change
# the uninterrupted steps made to it. The same ops on bit-equal inputs
# repeat bit for bit where the card's kernels are deterministic; a wrong
# learning rate, count or moment moves a leaf by a whole step's change.
RESUME_RTOL = 1e-3
# The fine-tuned encoder's bf16 embeddings against its CPU f32 forward, 16
# documents at T = 512: the reading is 8.5e-4 (bf16's 2^-9 relative per
# rounding, through 12 layers, on L2-normalised vectors whose elements are
# ~0.036); 5e-3 leaves room on both sides and is well below the elements'
# size, where ENC_TOL's 3e-2 is not.
FT_ENC_TOL = 5e-3
# 6c (e): the decoder step at Qwen2-0.5B's widths
LM_STEP_B, LM_STEP_T = 4, 512
GEMM_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")


def encoder_step_flops(cfg, b: int, t: int) -> float:
    """Model FLOPs of one InfoNCE step (two forwards of [b, t] and their
    backwards, 3x the forward; remat's recompute not counted): the layer
    GEMMs, attention's two products and the output projection."""
    d, f, n = cfg.d_model, cfg.d_ff, cfg.n_layers
    per_token = 2 * n * (4 * d * d + 2 * d * f) + 4 * n * t * d + 2 * d * cfg.out_dim
    return 3.0 * 2 * b * t * per_token


def decoder_step_flops(cfg, b: int, t: int) -> float:
    """Model FLOPs of one LM step: 3x the forward's GEMMs (q, k, v, o, the
    gated MLP, the tied head) and attention's two products."""
    d, f, n, kv = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.kv_dim
    per_token = (2 * n * (2 * d * d + 2 * d * kv + 3 * d * f) + 4 * n * t * d
                 + 2 * d * cfg.vocab_size)
    return 3.0 * b * t * per_token


def tree_to(tree: dict, device, dtype=None) -> dict:
    return {k: tree_to(v, device, dtype) if isinstance(v, dict)
            else v.detach().to(device=device, dtype=dtype or v.dtype).clone()
            for k, v in tree.items()}


def trees_equal(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            trees_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a.cpu(), b.cpu()))


def train_split(step, update, wall_ms: float) -> dict:
    """One training step's device time by kind (torch.profiler, kernel
    names): the GEMMs (cuBLAS and CUTLASS kernels), the optimizer (a
    profile of ``update`` alone, the same update on the same gradients),
    the rest of the forward and backward (elementwise, norms, casts, the
    loss); the host's share, the step's wall time less its device time;
    and the five kernels that take the most device time. ms each."""
    kernels = device_kernels(step, 1)
    total = sum(us for _, us in kernels.values()) / 1e3
    gemm = sum(us for n, (_, us) in kernels.items()
               if any(w in n.lower() for w in GEMM_KERNELS)) / 1e3
    opt_ms = sum(us for _, us in device_kernels(update, 1).values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:5]
    return {"device": total, "GEMMs": gemm, "optimizer": opt_ms,
            "the rest of forward and backward": max(total - gemm - opt_ms, 0.0),
            "host (wall less device)": max(wall_ms - total, 0.0),
            "top": [(n[:72], c, us / 1e3) for n, (c, us) in top]}


def print_split(split: dict) -> None:
    print("  a step's device split (torch.profiler, one step): " + "; ".join(
        f"{k} {split[k]:.2f} ms" for k in ("device", "GEMMs", "optimizer",
                                           "the rest of forward and backward",
                                           "host (wall less device)")))
    for name, count, ms in split["top"]:
        print(f"    {ms:8.3f} ms  x{count:<4d} {name}")


def encoder_fine_tune(seed: int, root: str, part: str) -> dict:
    """6c (a): train_embedder's main in this process on the card, a
    checkpoint at step 100, then the checkpoint's restore, a resumed run's
    learning rates and one step's gradients against a CPU f32 twin."""
    import dataclasses

    from youtu_rag_tpu_torch import train_embedder
    from youtu_rag_tpu_torch.models import train as tr
    from youtu_rag_tpu_torch.models.checkpoint import TrainCheckpointer
    from youtu_rag_tpu_torch.models.encoder import count_params, load_encoder_config
    from youtu_rag_tpu_torch.models.tokenizer import HashTokenizer

    out = os.path.join(root, "ft")
    marks, snap = [], {}

    def on_step(step, params, opt_state, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        snap["final"] = params  # updated in place: the last step's parameters
        if step == 100:
            snap["params"], snap["opt"] = tree_to(params, "cpu"), tree_to(opt_state, "cpu")
        if 100 < step <= 105:
            snap[step] = tree_to(params, "cpu")

    reset_launches()
    t0 = time.perf_counter()
    report = train_embedder.main(TRAIN_ARGS + ["--out", out, "--seed", str(seed)],
                                 on_step=on_step)
    wall = time.perf_counter() - t0
    train_launches = attention_counts()
    losses = report["losses"]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"6c (a): losses {losses[:5]}...")
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    check(last < first, f"6c (a): the last 20 steps' mean loss {last} is not below the first "
          f"20's {first}")
    r0, r1 = report["recall_before"]["recall@1"], report["recall_after"]["recall@1"]
    check(r1 > r0, f"6c (a): holdout recall@1 {r1} after is not above {r0} before")
    check(sum(train_launches.values()) == 0,
          f"6c (a): training launched attention kernels: {train_launches}")
    step_ms = np.diff(marks) * 1e3
    targs = train_embedder.parse_args(TRAIN_ARGS + ["--seed", str(seed)])
    b, t = targs.batch, targs.seqlen
    cfg = dataclasses.replace(load_encoder_config(os.path.join(out, "encoder_config.json")),
                              max_len=t)
    med = float(np.median(step_ms))
    flops = encoder_step_flops(cfg, b, t)
    bound_ms = flops / BF16_PEAK[part] * 1e3
    print(f"  {report['pairs']} train pairs; loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of "
          f"the first 20 {first:.4f}, the last 20 {last:.4f}); holdout recall@1 {r0} -> {r1}, "
          f"recall@5 {report['recall_before']['recall@5']} -> {report['recall_after']['recall@5']}")
    print(f"  ms a step (B {b}, T {t}, steps 2-{TRAIN_STEPS}): median {med:.2f}, p10 "
          f"{np.percentile(step_ms, 10):.2f}, p90 {np.percentile(step_ms, 90):.2f}, max "
          f"{step_ms.max():.2f}; {2 * b * t / med * 1e3:.0f} tokens/s; model FLOPs "
          f"{flops / 1e12:.2f} T a step, {bound_ms:.2f} ms at {BF16_PEAK[part] / 1e12:.0f} "
          f"TFLOP/s ({100 * bound_ms / med:.1f} % of the step); the run {wall:.1f} s")

    # the checkpoint: step 100 restored bit-equal, then 5 resumed steps on
    # the uninterrupted run's batches 101-105 give its parameters
    ck = TrainCheckpointer(os.path.join(out, "ckpt"))
    check(ck.all_steps() == [100, TRAIN_STEPS], f"6c (a): checkpoints {ck.all_steps()}")
    tc = train_embedder.train_config(targs)
    opt = tr.make_optimizer(tc)
    t0 = time.perf_counter()
    params, state, meta = ck.restore(100, params_like=snap["final"],
                                     opt_state_like=opt.init(snap["final"]))
    restore_s = time.perf_counter() - t0
    check(trees_equal(params, snap["params"]) and trees_equal(state, snap["opt"])
          and int(state["count"]) == 100 and np.isfinite(meta["loss"]),
          "6c (a): the step-100 checkpoint does not restore bit-equal")
    pairs, _ = train_embedder.training_pairs(targs)
    tok = HashTokenizer(cfg.vocab_size, cfg.max_len)  # train_embedder.main's
    step_fn = tr.make_train_step(cfg, tc, opt)
    run_batches = train_embedder.make_batches(pairs, tok, b, t, 105, targs.seed)
    worst, prev = 0.0, snap["params"]
    for i, batch in enumerate(itertools.islice(run_batches, 100, 105)):
        params, state, m = step_fn(params, state, batch)
        check(np.isfinite(float(m["loss"])), "6c (a): a resumed loss is not finite")
        want = snap[101 + i]
        for name, got, w, w0 in zip(tr.leaf_names(want), tr.leaves(params), tr.leaves(want),
                                    tr.leaves(prev)):
            moved = float((w - w0).abs().max())
            diff = float((got.detach().cpu() - w).abs().max())
            check(diff <= RESUME_RTOL * moved,
                  f"6c (a): resumed step {101 + i}'s {name} is {diff} from the run's "
                  f"(the run's step moved it {moved})")
            worst = max(worst, diff / moved if moved else 0.0)
        prev = want
    check(int(state["count"]) == 105, "6c (a): the resumed count")
    print(f"  checkpoint steps {ck.all_steps()}; step 100 restored bit-equal in {restore_s:.1f} s "
          f"(params, optimizer moments, count 100); 5 resumed steps give the uninterrupted "
          f"run's parameters after steps 101-105 within {worst:.2e} of a step's change (gate "
          f"{RESUME_RTOL})")

    # where a step's time goes, on the last resumed batch
    (_, _), grads = tr.value_and_grad(tr.info_nce_loss, params, tr.as_batch(batch, "cuda"),
                                      cfg, tc)
    print_split(train_split(lambda: step_fn(params, state, batch),
                            lambda: opt.update(grads, state, params), med))
    del grads

    # one step's gradients at the step-100 parameters (the final ones fit
    # their batches to a loss near 0, where the gradients are rounding),
    # card f32 (TF32 off) against the CPU f32 twin
    params = tree_to(snap["params"], "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = dataclasses.replace(cfg, dtype=torch.float32, attention_impl="xla")
    batch = next(train_embedder.make_batches(pairs, tok, 8, 64, 1, seed + 7))
    tc0 = tr.TrainConfig(remat=False)
    (card_loss, _), card_g = tr.value_and_grad(tr.info_nce_loss, params,
                                                tr.as_batch(batch, "cuda"), f32, tc0)
    cpu_params = snap["params"]
    t0 = time.perf_counter()
    (cpu_loss, _), cpu_g = tr.value_and_grad(tr.info_nce_loss, cpu_params,
                                              tr.as_batch(batch, "cpu"), f32, tc0)
    cpu_s = time.perf_counter() - t0
    worst, worst_name = 0.0, ""
    names = list(tr.leaf_names(params))
    for name, g, w in zip(names, card_g, cpu_g):
        scale = float(w.abs().max())
        if scale == 0.0:
            check(float(g.abs().max()) == 0.0, f"6c (a): {name} has a gradient only on the card")
            continue
        rel = float((g.cpu() - w).abs().max()) / scale
        if rel > worst:
            worst, worst_name = rel, name
    print(f"  gradients, card f32 vs CPU f32 (B 8, T 64; CPU {cpu_s:.1f} s): loss "
          f"{float(card_loss):.6f} vs {float(cpu_loss):.6f}; the worst leaf {worst_name} at "
          f"{worst:.2e} of its largest gradient (gate {GRAD_RTOL}); {len(names)} leaves, "
          f"{count_params(params) / 1e6:.1f} M parameters")
    check(worst <= GRAD_RTOL, f"6c (a): {worst_name}'s gradient differs by {worst} relative")
    del cpu_params, cpu_g, card_g, snap, params, state
    return {"out": out, "report": report, "pairs": pairs}


def fine_tuned_serves(seed: int, root: str, ft: dict) -> dict:
    """6c (b): the saved directory served by TorchEmbedder on the card with
    "pallas": 64 of 4f's documents at T = 512 (blockwise), 16 of them
    against the CPU f32 forward; then a KB over the holdout positives whose
    searches launch topk_pruned, its recall@1 against eval_recall's."""
    import dataclasses

    from youtu_rag_tpu_torch import train_embedder
    from youtu_rag_tpu_torch.core.types import Document
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder
    from youtu_rag_tpu_torch.retrieval.kb import KnowledgeBase

    served = TorchEmbedder.from_weights_dir(ft["out"], device="cuda")
    check(served.cfg.attention_impl == "xla" and served.cfg.max_len == 512,
          f"6c (b): the saved config reads {served.cfg}")
    emb = TorchEmbedder(config=dataclasses.replace(served.cfg, attention_impl="pallas"),
                        params=served.params, device="cuda")
    docs_dir = os.path.join(root, "docs")
    os.makedirs(docs_dir)
    names = [f"doc{i:04d}.md" for i in range(64)]
    write_ingest_corpus(docs_dir, seed, names=names)
    texts = [open(os.path.join(docs_dir, n)).read() for n in names]
    reset_launches()
    vecs = emb.embed_batch(texts)
    torch.cuda.synchronize()
    block_launches = attention_counts()["blockwise_attention"]
    check(block_launches > 0 and block_launches % 12 == 0,
          f"6c (b): {block_launches} blockwise launches for 64 documents at T = 512")
    f32 = dataclasses.replace(served.cfg, dtype=torch.float32, attention_impl="xla")
    cpu = TorchEmbedder(config=f32, params=tree_to(served.params, "cpu"), device="cpu")
    t0 = time.perf_counter()
    ref = cpu.embed_batch(texts[:16])
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(vecs[:16] - ref).max())
    check(np.isfinite(vecs).all() and err <= FT_ENC_TOL,
          f"6c (b): embeddings {err} from the CPU f32 forward")
    print(f"  64 documents at T = 512 through the fine-tuned encoder ('pallas'): "
          f"{block_launches} blockwise launches; 16 of them against the CPU f32 forward "
          f"({cpu_s:.1f} s): max |diff| {err:.2e} (gate {FT_ENC_TOL})")
    del cpu

    # a KB over the holdout positives, searched with each holdout query
    args = train_embedder.parse_args(TRAIN_ARGS + ["--seed", str(seed)])
    _, holdout = train_embedder.training_pairs(args)
    kb = KnowledgeBase("ft_holdout", device="cuda")
    serve_with(kb, emb)
    asyncio.run(kb.build_documents([Document(id=f"h{i:03d}", content=p)
                                    for i, (_, p, _) in enumerate(holdout)]))
    q = emb.embed_batch([h[0] for h in holdout])
    d = emb.embed_batch([h[1] for h in holdout])
    scores = q @ d.T
    margin = np.diag(scores) - np.max(np.where(np.eye(len(holdout), dtype=bool), -np.inf, scores),
                                      axis=1)
    reset_launches()
    tops = []
    for query, _, _ in holdout:
        hits = asyncio.run(kb.retriever.retrieve(query, top_k=5, similarity_threshold=0.0))
        tops.append(hits[0].chunk.document_id if hits else None)
    torch.cuda.synchronize()
    launches = launch_counts()["bfloat16"]
    check(launches >= len(holdout), f"6c (b): {launches} topk_pruned launches for "
          f"{len(holdout)} queries")
    kb_hit = np.array([top == f"h{i:03d}" for i, top in enumerate(tops)])
    eval_hit = margin >= 0
    differ = np.flatnonzero(kb_hit != eval_hit)
    check(all(abs(margin[i]) <= TIE_TOL for i in differ),
          f"6c (b): the KB and eval_recall differ beyond near-ties at {differ.tolist()}: "
          f"margins {margin[differ].tolist()}")
    r_eval = train_embedder.eval_recall(served.params, served.cfg, holdout,
                                        tokenizer=served.tokenizer)["recall@1"]
    check(abs(r_eval - kb_hit.mean()) <= len(differ) / len(holdout) + 1e-4,
          f"6c (b): the KB's recall@1 {kb_hit.mean()} against eval_recall's {r_eval}")
    print(f"  a KB of {len(holdout)} holdout positives: {launches} topk_pruned launches; "
          f"recall@1 {kb_hit.mean():.4f} through the retriever, {eval_hit.mean():.4f} from the "
          f"same embeddings, eval_recall {r_eval}; {len(differ)} near-ties differ (margins "
          f"{[round(float(margin[i]), 5) for i in differ]}, gate {TIE_TOL})")
    return {"blockwise_attention": block_launches, "topk_pruned": launches}


def moe_step(seed: int, pairs: list) -> None:
    """6c (c): make_moe_train_step at the default widths, 8 experts, 3
    steps at B = 64, T = 128; the experts' token shares."""
    from youtu_rag_tpu_torch import train_embedder
    from youtu_rag_tpu_torch.models import train as tr
    from youtu_rag_tpu_torch.models.encoder import EncoderConfig, count_params
    from youtu_rag_tpu_torch.models.tokenizer import HashTokenizer
    from youtu_rag_tpu_torch.parallel.expert_parallel import expert_shares, init_moe_params

    cfg = EncoderConfig(max_len=128)
    tc = tr.MoETrainConfig(learning_rate=1e-4, warmup_steps=1, total_steps=10, n_experts=8)
    params = tree_to(init_moe_params(cfg, 8, torch.Generator().manual_seed(seed)), "cuda")
    opt = tr.make_optimizer(tc)
    state, step = opt.init(params), tr.make_moe_train_step(cfg, tc, opt)
    batches = list(train_embedder.make_batches(pairs, HashTokenizer(cfg.vocab_size, 512), 64, 128,
                                               3, seed + 3))
    ms = []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        loss, aux = float(m["loss"]), float(m["aux_loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
        check(np.isfinite(loss) and np.isfinite(aux), f"6c (c): loss {loss}, aux {aux}")
        print(f"  MoE step: loss {loss:.4f}, contrastive {float(m['contrastive_loss']):.4f}, aux "
              f"{aux:.4f}, {ms[-1]:.1f} ms")
    b = tr.as_batch(batches[-1], "cuda")
    shares = expert_shares(params, b["q_ids"], b["q_mask"], cfg, 8)
    print(f"  {count_params(params) / 1e6:.1f} M parameters; the experts' token shares, mean over "
          f"{cfg.n_layers} layers: {np.round(shares.mean(axis=0), 4).tolist()} (layer min "
          f"{shares.min():.4f}, max {shares.max():.4f})")
    del params, state


def chat_lm(seed: int, root: str) -> int:
    """6c (d): train_chat_lm at yrt_tiny_chat's widths, CHAT_LM_STEPS at B = 32,
    then its outputs through cli_chat --llm-weights-dir. Returns the
    topk_pruned launches of the CLI's searches."""
    from youtu_rag_tpu_torch import train_chat_lm

    out = os.path.join(root, "lm")
    losses, marks = [], []

    def on_step(step, params, opt_state, metrics):
        losses.append(float(metrics["loss"]))
        marks.append(time.perf_counter())

    t0 = time.perf_counter()
    report = train_chat_lm.main(["--steps", str(CHAT_LM_STEPS), "--batch", "32",
                                 "--eval-every", str(CHAT_LM_STEPS),
                                 "--seed", str(seed), "--out", out], on_step=on_step)
    wall = time.perf_counter() - t0
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    check(np.isfinite(losses).all() and last < first,
          f"6c (d): the loss does not fall: first 20 {first}, last 20 {last}")
    ev = report["evals"][-1]
    step_ms = np.diff(marks) * 1e3
    print(f"  {report['params']:,} parameters, T {report['max_len']}, vocab {report['vocab']}: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (first 20 {first:.4f}, last 20 {last:.4f}); "
          f"{float(np.median(step_ms)):.2f} ms a step (median, data included); eval@{ev['step']}: "
          f"action_valid {ev['action_valid']}, query_exact {ev['query_exact']}, answer_exact "
          f"{ev['answer_exact']}; the run {wall:.1f} s")
    facts = os.path.join(root, "facts")
    os.makedirs(facts)
    asked = write_fact_corpus(facts, seed)[:1]
    reset_launches()
    blocks, calls, _ = run_cli(["--paths", facts, "--llm-weights-dir", out], [asked[0][0]])
    launches = launch_counts()["bfloat16"]
    check(len(blocks) == 1 and "[error" not in blocks[0],
          f"6c (d): cli_chat on the trained model: {blocks}")
    print(f"  cli_chat --llm-weights-dir on the trained model: > {asked[0][0]}\n    "
          + blocks[0].replace("\n", "\n    ") + f"\n  ({len(calls)} tool calls, {launches} "
          "topk_pruned launches)")
    return launches


def decoder_step(seed: int, part: str) -> None:
    """6c (e): make_lm_train_step at Qwen2-0.5B's widths (f32 parameters from
    the seed, bf16 activations), B = 4, T = 512, 5 steps on one batch with
    remat on, then 2 with it off; peak memory of each."""
    from youtu_rag_tpu_torch.models import decoder as td
    from youtu_rag_tpu_torch.models import train as tr
    from youtu_rag_tpu_torch.models import train_lm as tl
    from youtu_rag_tpu_torch.models.encoder import count_params

    c = QWEN2_05B
    cfg = td.DecoderConfig(
        vocab_size=c["vocab_size"], d_model=c["hidden_size"], n_layers=c["num_hidden_layers"],
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        d_ff=c["intermediate_size"], max_len=LM_STEP_T, arch="llama", dtype=torch.bfloat16,
        rope_base=c["rope_theta"], ln_eps=c["rms_norm_eps"], tie_embeddings=True,
        eos_token_id=c["eos_token_id"], qkv_bias=True)
    t0 = time.perf_counter()
    params = td.init_decoder_params(cfg, torch.Generator().manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(seed + 5)
    b, t = LM_STEP_B, LM_STEP_T
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, t), generator=g),
             "mask": torch.ones(b, t), "loss_mask": torch.ones(b, t)}
    batch["loss_mask"][:, :64] = 0.0
    out = {}
    for remat, steps in ((True, 5), (False, 2)):
        tc = tl.LMTrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=100, remat=remat)
        opt = tl.make_lm_optimizer(tc)
        state, step = opt.init(params), tl.make_lm_train_step(cfg, tc, opt)
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        out[remat] = (losses, ms, torch.cuda.max_memory_allocated() / 2**30)
        if remat:
            (_, _), grads = tr.value_and_grad(lambda p, bt: (tl.lm_loss(p, bt, cfg, tc), {}),
                                              params, tr.as_batch(batch, "cuda"))
            split = train_split(lambda: step(params, state, batch),
                                lambda: opt.update(grads, state, params),
                                float(np.median(ms[1:])))
            del grads
        del state
    losses, ms, peak_on = out[True]
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"6c (e): the loss does not fall over 5 steps: {losses}")
    flops = decoder_step_flops(cfg, b, t)
    med = float(np.median(ms[1:]))
    print(f"  {count_params(params) / 1e6:.1f} M parameters (initialized in {init_s:.1f} s); "
          f"remat on: losses {[round(x, 4) for x in losses]}; {med:.1f} ms a step (median of "
          f"steps 2-5), {b * t / med * 1e3:.0f} tokens/s, model FLOPs {flops / 1e12:.2f} T "
          f"({flops / BF16_PEAK[part] * 1e3:.2f} ms at peak); peak memory {peak_on:.2f} GiB; "
          f"remat off: {[round(x, 1) for x in out[False][1]]} ms, peak {out[False][2]:.2f} GiB")
    print_split(split)
    del params


def training_on_card(seed: int, part: str) -> dict:
    """6c: (a)-(e) above, each part's wall time printed. Returns the main
    path's launches of rows 1 and 6 in 6c."""
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        t0 = time.perf_counter()
        ft = encoder_fine_tune(seed, root, part)
        t1 = time.perf_counter()
        print(f"  (a) {t1 - t0:.1f} s")
        served = fine_tuned_serves(seed, root, ft)
        t2 = time.perf_counter()
        print(f"  (b) {t2 - t1:.1f} s")
        pairs = ft["pairs"]
        del ft
        torch.cuda.empty_cache()
        moe_step(seed, pairs)
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        print(f"  (c) {t3 - t2:.1f} s")
        cli_launches = chat_lm(seed, root)
        t4 = time.perf_counter()
        print(f"  (d) {t4 - t3:.1f} s")
        decoder_step(seed, part)
        torch.cuda.empty_cache()
        print(f"  (e) {time.perf_counter() - t4:.1f} s")
    return {"blockwise_attention": served["blockwise_attention"],
            "topk_pruned": served["topk_pruned"] + cli_launches}


# ---------------------------------------------------------------------------
# 6d. training and inference over a mesh
# ---------------------------------------------------------------------------

# One sharded step against the one-device step, f32 with TF32 off. The
# losses: rtol 2e-4 (JAX's own for its sharded steps). The gradients the
# step applies (summed over dp, gathered over tp or ep): each leaf within
# GRAD_RTOL (6c's 1e-3) of its largest one-device gradient; they carry
# what the sharding computes, since Adam's update is blind to a gradient's
# scale (a first update is ~lr · sign(g): a gradient counted tp times
# moves the parameters as the right one does). The parameters after the
# step: the share of elements whose change differs from the one-device
# step's by more than 1e-3 of the leaf's largest change, at most
# MESH_FLIP_SHARE, among the elements whose gradient exceeds GRAD_RTOL of
# the leaf's largest: an element whose gradient is within the sums'
# rounding of 0 (a key bias's, 0 in exact arithmetic, is all of them)
# takes either sign and moves by up to 2 lr in the other run. And over
# every element, each leaf's norm of the difference of the changes at most
# MESH_CHANGE_RTOL of the norm of the one-device change (the readings on an
# H100 80GB HBM3 at 700.00 W: 5.73e-05, 1.16e-06 and 2.42e-04 for (a), (b)
# and (c)), which holds the optimizer's per-shard moments and the clip's
# global norm on the unresolved elements too.
MESH_LOSS_RTOL = 2e-4
MESH_FLIP_SHARE = 1e-3
MESH_CHANGE_RTOL = 1e-3
MESH_B, MESH_T = 64, 128  # the encoder steps' batch (6c's)


def card_init(fn, seed: int):
    """``fn(generator)`` with its tensors drawn on the card from ``seed``."""
    with torch.device("cuda"):
        return fn(torch.Generator(device="cuda").manual_seed(seed))


def card_mesh(axes: dict):
    """A local mesh of ``axes`` whose every slot is the card."""
    from youtu_rag_tpu_torch.parallel.mesh import get_mesh

    return get_mesh(axes, devices=["cuda"] * int(np.prod(list(axes.values()))))


def token_batch(seed: int, b: int, t: int, vocab: int) -> dict:
    """q/d ids and masks of ragged rows (lengths t/4..t), from a numpy seed."""
    r = np.random.default_rng(seed)
    out = {}
    for side in "qd":
        n = r.integers(t // 4, t + 1, b)
        mask = (np.arange(t)[None] < n[:, None]).astype(np.float32)
        ids = (r.integers(1, vocab, (b, t)) * mask).astype(np.int64)
        out[f"{side}_ids"] = torch.from_numpy(ids)
        out[f"{side}_mask"] = torch.from_numpy(mask)
    return out


def timed_steps(step, params, state, batches) -> tuple[list[float], list[float], object, object]:
    """(losses, ms of each step, params, state) over ``batches``."""
    losses, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, params, state


def grads_agree(got: dict, want: list, names: list[str]) -> tuple[float, str]:
    """The worst leaf's max |got - want| over its largest |want| (GRAD_RTOL's
    measure); ``got`` a full gradient tree, ``want`` the one-device list."""
    from youtu_rag_tpu_torch.models import train as tr

    worst, worst_name = 0.0, ""
    for name, g, w in zip(names, tr.leaves(got), want):
        scale = float(w.abs().max())
        diff = float((g.detach() - w.detach()).abs().max())
        if scale == 0.0:
            check(diff == 0.0, f"6d: {name} has a gradient only in the sharded step")
            continue
        if diff / scale > worst:
            worst, worst_name = diff / scale, name
    return worst, worst_name


def changes_agree(full_after: dict, one_after: dict, before: dict,
                  grads: list) -> tuple[float, str, float, str]:
    """(the largest share of a leaf's elements whose change differs from the
    one-device step's by more than 1e-3 of the leaf's largest change, among
    the elements whose one-device gradient ``grads`` exceeds GRAD_RTOL of
    the leaf's largest, where its sign is resolved, and that leaf; the
    largest norm of the difference over the norm of the change, over every
    element, and that leaf)."""
    from youtu_rag_tpu_torch.models import train as tr

    share, ratio, worst_name, ratio_name = 0.0, 0.0, "", ""
    for name, a, b, p0, g in zip(tr.leaf_names(before), tr.leaves(full_after),
                                 tr.leaves(one_after), tr.leaves(before), grads):
        da, db = (a.detach() - p0).float(), (b.detach() - p0).float()
        moved = float(db.abs().max())
        if moved == 0.0:
            check(float(da.abs().max()) == 0.0, f"6d: {name} moved only in the sharded step")
            continue
        resolved = g.detach().abs() > GRAD_RTOL * float(g.detach().abs().max())
        if bool(resolved.any()):
            sh = float(((da - db).abs() > 1e-3 * moved)[resolved].float().mean())
            if sh > share:
                share, worst_name = sh, name
        r = float((da - db).norm() / db.norm())
        if r > ratio:
            ratio, ratio_name = r, name
    return share, worst_name, ratio, ratio_name


def sharded_against_one(what: str, make_sharded, make_one, p0: dict, batches32, batches16):
    """6d (a)-(c)'s gates and times: the f32 steps (TF32 off) of the sharded
    and the one-device step from ``p0``, the first one's gradients too; then
    bf16-activation steps of each: ms a step, every replica bit-equal,
    finite losses. ``make_sharded(dtype, params)`` returns (step, placed,
    state), the step with ``.grads``; ``make_one(dtype, params)`` (step,
    params, state, loss_fn) for ``value_and_grad``."""
    from youtu_rag_tpu_torch.models import train as tr

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        step, placed, state = make_sharded(torch.float32, p0)
        _, g_sh = step.grads(placed, batches32[0])
        l_sh, _, placed, state = timed_steps(step, placed, state, batches32)
        sharded_after = placed.gather()
        del placed, state
        step, params, state, loss_fn = make_one(torch.float32, tree_to(p0, "cuda"))
        (_, _), g_one = tr.value_and_grad(loss_fn, params,
                                          tr.as_batch(batches32[0], params["tok_emb"].device))
        grad_rel, grad_name = grads_agree(g_sh, g_one, tr.leaf_names(params))
        del g_sh
        l_one, _, params, state = timed_steps(step, params, state, batches32)
        del state
        share, name, ratio, ratio_name = changes_agree(sharded_after, params, p0, g_one)
        del sharded_after, params, g_one
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_sh, l_one))
    grads_read = (f"the worst leaf {grad_name} at {grad_rel:.2e} of its largest" if grad_name
                  else "every leaf equal")
    share_read = (f"a share {share:.2e} of {name}'s resolved elements off" if name
                  else "no resolved element off")
    print(f"  {what}, f32 (TF32 off), {len(batches32)} step(s): losses sharded "
          f"{[round(x, 6) for x in l_sh]}, one device {[round(x, 6) for x in l_one]} (worst "
          f"relative {rel:.2e}, gate {MESH_LOSS_RTOL}); gradients: {grads_read} (gate "
          f"{GRAD_RTOL}); the parameters' change: {share_read} by more than 1e-3 of the leaf's "
          f"largest change (gate {MESH_FLIP_SHARE}); the worst norm ratio {ratio:.2e} "
          f"({ratio_name or 'none'}, gate {MESH_CHANGE_RTOL})")
    check(rel <= MESH_LOSS_RTOL, f"6d {what}: losses differ by {rel} relative")
    check(grad_rel <= GRAD_RTOL, f"6d {what}: {grad_name}'s gradient differs by {grad_rel}")
    check(share <= MESH_FLIP_SHARE, f"6d {what}: {share} of {name}'s changes differ")
    check(ratio <= MESH_CHANGE_RTOL, f"6d {what}: {ratio_name}'s change differs by a norm "
          f"ratio {ratio}")

    torch.cuda.reset_peak_memory_stats()
    step, placed, state = make_sharded(torch.bfloat16, p0)
    l_sh, ms_sh, placed, state = timed_steps(step, placed, state, batches16)
    peak_sh = torch.cuda.max_memory_allocated() / 2**30
    reps = len(placed)
    equal = all(all(torch.equal(a, b) for a, b in zip(tr.leaves(placed[0]), tr.leaves(r)))
                for r in placed[1:])
    del placed, state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, params, state, _ = make_one(torch.bfloat16, tree_to(p0, "cuda"))
    l_one, ms_one, params, state = timed_steps(step, params, state, batches16)
    peak_one = torch.cuda.max_memory_allocated() / 2**30
    del params, state
    torch.cuda.empty_cache()
    check(all(np.isfinite(l_sh)) and all(np.isfinite(l_one)), f"6d {what}: bf16 losses {l_sh}")
    check(equal, f"6d {what}: the {reps} dp replicas are not bit-equal")
    med_sh, med_one = float(np.median(ms_sh[1:])), float(np.median(ms_one[1:]))
    print(f"  {what}, bf16 activations, {len(batches16)} steps: sharded {med_sh:.1f} ms a step "
          f"(median of steps 2-{len(batches16)}; {[round(x, 1) for x in ms_sh]}), peak "
          f"{peak_sh:.2f} GiB; one device {med_one:.1f} ms ({[round(x, 1) for x in ms_one]}), "
          f"peak {peak_one:.2f} GiB; sharded/one {med_sh / med_one:.2f}x; {reps} replica(s) "
          f"of the parameters (the dp rows share the card), bit-equal; losses "
          f"{[round(x, 4) for x in l_sh]} vs {[round(x, 4) for x in l_one]}")
    return {"ms": med_sh, "one_ms": med_one}


def mesh_encoder_steps(seed: int) -> dict:
    """6d (a): make_sharded_train_step over dp 2 x tp 2 at the default
    widths, B 64, T 128, against make_train_step."""
    from youtu_rag_tpu_torch.models import train as tr
    from youtu_rag_tpu_torch.models.encoder import EncoderConfig, init_encoder_params

    def cfg(dt):
        return EncoderConfig(max_len=MESH_T, dtype=dt)

    tc = tr.TrainConfig(learning_rate=1e-4, warmup_steps=0, total_steps=100)
    p0 = card_init(lambda g: init_encoder_params(cfg(torch.float32), g), seed)

    def make_sharded(dt, p):
        params, state, step = tr.make_sharded_train_step(cfg(dt), tc, card_mesh({"dp": 2, "tp": 2}),
                                                         init_params=p)
        return step, params, state

    def make_one(dt, p):
        opt = tr.make_optimizer(tc)
        return (tr.make_train_step(cfg(dt), tc, opt), p, opt.init(p),
                lambda q, b: tr.info_nce_loss(q, b, cfg(dt), tc))

    vocab = cfg(torch.float32).vocab_size
    b32 = [token_batch(seed + 10, MESH_B, MESH_T, vocab)]
    b16 = [token_batch(seed + 11 + i, MESH_B, MESH_T, vocab) for i in range(3)]
    return sharded_against_one("(a) encoder dp 2 x tp 2", make_sharded, make_one, p0, b32, b16)


def mesh_moe_steps(seed: int) -> dict:
    """6d (b): make_sharded_moe_train_step over dp 2 x ep 4, 8 experts, at
    the default widths, against make_moe_train_step; aux_loss > 0."""
    from youtu_rag_tpu_torch.models import train as tr
    from youtu_rag_tpu_torch.models.encoder import EncoderConfig
    from youtu_rag_tpu_torch.parallel.expert_parallel import init_moe_params

    def cfg(dt):
        return EncoderConfig(max_len=MESH_T, dtype=dt)

    tc = tr.MoETrainConfig(learning_rate=1e-4, warmup_steps=0, total_steps=100, n_experts=8)
    p0 = card_init(lambda g: init_moe_params(cfg(torch.float32), 8, g), seed + 1)
    aux = []

    def watch(step):
        def run(p, s, b):
            p, s, m = step(p, s, b)
            aux.append(float(m["aux_loss"]))
            return p, s, m
        run.grads = step.grads
        return run

    def make_sharded(dt, p):
        params, state, step = tr.make_sharded_moe_train_step(
            cfg(dt), tc, card_mesh({"dp": 2, "ep": 4}), init_params=p)
        return watch(step), params, state

    def make_one(dt, p):
        opt = tr.make_optimizer(tc)
        return (tr.make_moe_train_step(cfg(dt), tc, opt), p, opt.init(p),
                lambda q, b: tr.moe_info_nce_loss(q, b, cfg(dt), tc))

    vocab = cfg(torch.float32).vocab_size
    b32 = [token_batch(seed + 20, MESH_B, MESH_T, vocab)]
    b16 = [token_batch(seed + 21 + i, MESH_B, MESH_T, vocab) for i in range(3)]
    out = sharded_against_one("(b) MoE dp 2 x ep 4, 8 experts", make_sharded, make_one, p0, b32,
                              b16)
    check(all(a > 0 and np.isfinite(a) for a in aux), f"6d (b): aux losses {aux}")
    print(f"  (b) the sharded steps' aux losses {[round(a, 4) for a in aux]}")
    return out


def mesh_lm_steps(seed: int) -> dict:
    """6d (c): make_sharded_lm_train_step over dp 2 x tp 2 at Qwen2-0.5B's
    widths, B 4, T 512, remat on: 2 f32 steps against make_lm_train_step,
    then 2 bf16 steps; ms a step and peak memory."""
    from youtu_rag_tpu_torch.models import decoder as td
    from youtu_rag_tpu_torch.models import train_lm as tl

    c = QWEN2_05B

    def cfg(dt):
        return td.DecoderConfig(
            vocab_size=c["vocab_size"], d_model=c["hidden_size"],
            n_layers=c["num_hidden_layers"], n_heads=c["num_attention_heads"],
            n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"], max_len=LM_STEP_T,
            arch="llama", dtype=dt, rope_base=c["rope_theta"], ln_eps=c["rms_norm_eps"],
            tie_embeddings=True, eos_token_id=c["eos_token_id"], qkv_bias=True)

    tc = tl.LMTrainConfig(learning_rate=3e-4, warmup_steps=0, total_steps=100, remat=True)
    p0 = card_init(lambda g: td.init_decoder_params(cfg(torch.float32), g, device=g.device),
                   seed + 2)
    b, t = LM_STEP_B, LM_STEP_T

    def batch(s):
        g = torch.Generator().manual_seed(seed + 30 + s)
        out = {"tokens": torch.randint(0, c["vocab_size"], (b, t), generator=g),
               "mask": torch.ones(b, t), "loss_mask": torch.ones(b, t)}
        out["loss_mask"][:, : t // 8 * (s + 1)] = 0.0  # the completions: unequal counts
        out["loss_mask"][0, t // 8 :] = 0.0
        return out

    def make_sharded(dt, p):
        opt = tl.make_lm_optimizer(tc)
        step, place_params, place_batch = tl.make_sharded_lm_train_step(
            cfg(dt), tc, opt, card_mesh({"dp": 2, "tp": 2}), p)
        placed = place_params(p)

        def run(pp, s, bt):
            return step(pp, s, place_batch(bt))

        run.grads = lambda pp, bt: step.grads(pp, place_batch(bt))
        return run, placed, opt.init(placed)

    def make_one(dt, p):
        opt = tl.make_lm_optimizer(tc)
        return (tl.make_lm_train_step(cfg(dt), tc, opt), p, opt.init(p),
                lambda q, b: (tl.lm_loss(q, b, cfg(dt), tc), None))

    return sharded_against_one("(c) LM dp 2 x tp 2, Qwen2-0.5B widths, B 4, T 512, remat",
                               make_sharded, make_one, p0, [batch(0), batch(1)],
                               [batch(2), batch(3)])


def mesh_pp_forward(seed: int, part: str) -> dict:
    """6d (d): make_pp_encoder, S = 4 stages of 3 layers, M = 8
    microbatches, B 32, T 512, "pallas", bf16, under no_grad, against
    encode_tokens on the card. Blockwise launches: one per (stage,
    microbatch) the schedule runs, times the stage's layers."""
    from youtu_rag_tpu_torch.models.encoder import EncoderConfig, encode_tokens, init_encoder_params
    from youtu_rag_tpu_torch.parallel.pipeline_parallel import make_pp_encoder, shard_params_pp

    cfg = EncoderConfig(attention_impl="pallas")
    n_st, n_mb, b, t = 4, 8, 32, 512
    params = card_init(lambda g: init_encoder_params(cfg, g), seed + 3)
    ids = token_batch(seed + 40, b, t, cfg.vocab_size)
    ids, mask = ids["q_ids"].cuda(), ids["q_mask"].cuda()
    mesh = card_mesh({"pp": n_st})
    fn = make_pp_encoder(cfg, mesh, n_micro=n_mb)
    placed = shard_params_pp(params, mesh)
    pairs = sum(1 for tick in range(n_mb + n_st - 1) for s in range(n_st) if 0 <= tick - s < n_mb)
    want = pairs * (cfg.n_layers // n_st)
    reset_launches()
    emb, _ = fn(placed, ids, mask)
    torch.cuda.synchronize()
    counts = attention_counts()
    check(counts["blockwise_attention"] == want and counts["flash_attention"] == 0,
          f"6d (d): launches {counts}, the schedule's {want} blockwise")
    with torch.inference_mode():
        ref, _ = encode_tokens(params, ids, mask, cfg)
        diff = float((emb - ref).abs().max())
        pp_ms = time_ms(lambda: fn(placed, ids, mask), bursts=3, burst=2, warmup=1)
        one_ms = time_ms(lambda: encode_tokens(params, ids, mask, cfg), bursts=3, burst=2, warmup=1)
    bubble = (n_st - 1) / (n_mb + n_st - 1)
    print(f"  (d) PP, S {n_st} x {cfg.n_layers // n_st} layers, M {n_mb}, B {b}, T {t}: "
          f"{n_mb + n_st - 1} ticks, {pairs} stage runs, blockwise launches {want}; max |diff| "
          f"{diff:.3g} from encode_tokens (gate {ENC_TOL}); {pp_ms:.2f} ms device vs "
          f"{one_ms:.2f} ms unsharded ({pp_ms / one_ms:.2f}x; the schedule's bubble "
          f"{bubble:.3f} of a stage's ticks, idle on a mesh of cards, not on one card)")
    check(diff <= ENC_TOL, f"6d (d): PP differs from encode_tokens by {diff}")
    return {"blockwise_attention": want, "ms": pp_ms, "one_ms": one_ms}


def mesh_ep_forwards(seed: int) -> dict:
    """6d (e): make_ep_encoder and make_ep_encoder_a2a (dropless), 8 experts
    over ep 4, B 16, T 512, "pallas", against moe_encode_tokens; attention
    runs once a forward for every shard on the card: 12 blockwise
    launches each."""
    from youtu_rag_tpu_torch.models.encoder import EncoderConfig
    from youtu_rag_tpu_torch.parallel import expert_parallel as epm

    cfg = EncoderConfig(attention_impl="pallas")
    n_e, ep, b, t = 8, 4, 16, 512
    params = card_init(lambda g: epm.init_moe_params(cfg, n_e, g), seed + 4)
    batch = token_batch(seed + 50, b, t, cfg.vocab_size)
    ids, mask = batch["q_ids"].cuda(), batch["q_mask"].cuda()
    mesh = card_mesh({"ep": ep})
    placed = epm.shard_params_ep(params, mesh)
    fns = {"psum": epm.make_ep_encoder(cfg, mesh, n_e),
           "a2a": epm.make_ep_encoder_a2a(cfg, mesh, n_e, capacity_factor=float(ep),
                                          expert_capacity_factor=float(n_e))}
    out = {"blockwise_attention": 0}
    with torch.inference_mode():
        ref, _ = epm.moe_encode_tokens(params, ids, mask, cfg, n_e)
        one_ms = time_ms(lambda: epm.moe_encode_tokens(params, ids, mask, cfg, n_e), bursts=3,
                         burst=2, warmup=1)
        for name, fn in fns.items():
            reset_launches()
            emb, _ = fn(placed, ids, mask)
            torch.cuda.synchronize()
            counts = attention_counts()
            check(counts["blockwise_attention"] == cfg.n_layers,
                  f"6d (e) {name}: launches {counts}, want {cfg.n_layers} blockwise")
            out["blockwise_attention"] += counts["blockwise_attention"]
            diff = float((emb - ref).abs().max())
            ms = time_ms(lambda: fn(placed, ids, mask), bursts=3, burst=2, warmup=1)
            print(f"  (e) EP {name}, {n_e} experts over ep {ep}, B {b}, T {t}: max |diff| "
                  f"{diff:.3g} from moe_encode_tokens (gate {ENC_TOL}); {ms:.2f} ms device vs "
                  f"{one_ms:.2f} ms unsharded; blockwise launches {counts['blockwise_attention']}")
            check(diff <= ENC_TOL, f"6d (e) {name}: differs by {diff}")
    return out


def mesh_sp_tp(ring: dict, embedder) -> dict:
    """6d (f): make_sp_encoder over dp 1 x sp 4 x tp 2 on 5e's 8 documents
    at T 4096 against 5e's unsharded forward; each hop launches the stats
    kernel on a tp shard's heads: layers x tp x sp launches."""
    from youtu_rag_tpu_torch.parallel.sequence_parallel import make_sp_encoder

    cfg = embedder.cfg
    ids, mask, ref = ring["unsharded"]
    fn = make_sp_encoder(cfg, card_mesh({"dp": 1, "sp": 4, "tp": 2}), dp_axis="dp",
                         tp_axis="tp")
    want = cfg.n_layers * 2 * 4
    with torch.inference_mode():
        reset_launches()
        emb, _ = fn(embedder.params, ids, mask)
        torch.cuda.synchronize()
        counts = attention_counts()
        ms = time_ms(lambda: fn(embedder.params, ids, mask), bursts=3, burst=2, warmup=1)
    check(counts["flash_attention_stats"] == want and counts["blockwise_attention"] == 0,
          f"6d (f): launches {counts}, want {want} hops")
    diff = float(np.abs(emb.cpu().numpy() - ref).max())
    print(f"  (f) SP x TP, dp 1 x sp 4 x tp 2, 8 documents at T 4096 (Tl 1024, 6 heads a shard): "
          f"max |diff| {diff:.3g} from 5e's unsharded forward (gate {ENC_TOL}); {ms:.2f} ms "
          f"device vs the sp-4 ring's {ring['ring_ms']:.2f} ms; flash_attention_stats launches "
          f"{counts['flash_attention_stats']} ({cfg.n_layers} layers x 2 tp x 4 hops)")
    check(diff <= ENC_TOL, f"6d (f): differs from the unsharded forward by {diff}")
    return {"flash_attention_stats": counts["flash_attention_stats"]}


def mesh_train_embedder(seed: int, root: str) -> None:
    """6d (g): train_embedder.main --dp 2 --tp 2 for 10 steps on the card at
    the default preset (768 x 12): the gathered full tree's checkpoint and
    npz, whose compressed writes take most of this part's time; the npz
    serves in TorchEmbedder. Then --resume to step 12: the restored full
    tree placed on the mesh again, whose holdout recall before its steps
    is the first run's after its last."""
    from youtu_rag_tpu_torch import train_embedder
    from youtu_rag_tpu_torch.models.embedder import TorchEmbedder

    out = os.path.join(root, "ft_mesh")

    def run(steps: int, *extra: str) -> dict:
        return train_embedder.main(["--synthetic", "64", "--paraphrase", "128", "--batch", "64",
                                    "--seqlen", "128", "--steps", str(steps), "--ckpt-every",
                                    "10", "--warmup", "2", "--holdout", "32", "--dp", "2",
                                    "--tp", "2", "--seed", str(seed), "--out", out, *extra])

    t0 = time.perf_counter()
    report = run(10)
    wall = time.perf_counter() - t0
    losses = report["losses"]
    check(len(losses) == 10 and all(np.isfinite(losses)), f"6d (g): losses {losses}")
    emb = TorchEmbedder.from_weights_dir(out, device="cuda")
    vec = emb.embed_batch(["What is the batch lot recorded for KL-4407?"])
    check(vec.shape == (1, emb.dimension) and abs(float(np.linalg.norm(vec)) - 1.0) < 1e-3,
          f"6d (g): the npz serves {vec.shape}")
    del emb
    t1 = time.perf_counter()
    resumed = run(12, "--resume")
    wall_resume = time.perf_counter() - t1
    check(len(resumed["losses"]) == 2 and all(np.isfinite(resumed["losses"])),
          f"6d (g): resumed losses {resumed['losses']}")
    check(resumed["recall_before"] == report["recall_after"],
          f"6d (g): resumed at {resumed['recall_before']}, saved at {report['recall_after']}")
    print(f"  (g) train_embedder --dp 2 --tp 2, 10 steps: losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, recall@1 {report['recall_before']['recall@1']} -> "
          f"{report['recall_after']['recall@1']}; its npz served by TorchEmbedder; {wall:.1f} s; "
          f"--resume to step 12: recall {resumed['recall_before']} as saved, losses "
          f"{[round(x, 4) for x in resumed['losses']]}, {wall_resume:.1f} s")


def mesh_dryrun() -> dict:
    """6d (h): dryrun_multichip(4) on four slots of the card."""
    from youtu_rag_tpu_torch.dryrun import dryrun_multichip

    reset_launches()
    out = dryrun_multichip(4, devices=["cuda"] * 4)
    torch.cuda.synchronize()
    counts = {**{KERNEL_NAMES[t]: n for t, n in launch_counts().items()},
              **{IVF_NAMES[t]: n for t, n in ivf_counts().items()}, **attention_counts(),
              **blocks_counts()}
    print(f"  (h) dryrun_multichip(4): {out}; launches {counts}")
    check(counts["topk_pruned"] > 0 and counts["topk_int4_pruned"] > 0
          and counts["ivf_topk_dma"] > 0, f"6d (h): the sharded index launched {counts}")
    return counts


def tf32_kept(seed: int) -> None:
    """6d (0): a caller's allow_tf32 = True survives a brute search, an IVF
    search, an f32 encoder forward and a k-means fit on the card."""
    from youtu_rag_tpu_torch.core.config import IndexConfig
    from youtu_rag_tpu_torch.core.types import Chunk
    from youtu_rag_tpu_torch.index import DeviceVectorIndex
    from youtu_rag_tpu_torch.models.encoder import EncoderConfig, encode_tokens, init_encoder_params
    from youtu_rag_tpu_torch.ops import kmeans_fit

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x = np.random.default_rng(seed).standard_normal((8192, 128)).astype(np.float32)
        idx = DeviceVectorIndex(128, IndexConfig(block_rows=256, n_lists=16, n_probe=4),
                                device="cuda")
        idx.add([Chunk(f"c{i}", "doc", "", i) for i in range(len(x))], x)
        seen = [idx.search(x[:4], top_k=3)[0][0][0].id]
        idx.build_ivf()
        seen.append(idx.search(x[:4], top_k=3)[0][0][0].id)
        after_search = torch.backends.cuda.matmul.allow_tf32
        cfg = EncoderConfig(n_layers=2, dtype=torch.float32)
        params = card_init(lambda g: init_encoder_params(cfg, g), seed)
        with torch.inference_mode():
            encode_tokens(params, torch.randint(1, 1000, (2, 64), device="cuda"),
                          torch.ones(2, 64, device="cuda"), cfg)
        kmeans_fit(torch.from_numpy(x).cuda(), 16)
        torch.cuda.synchronize()
        kept = torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    print(f"  (0) allow_tf32 set True: after a brute and an IVF search {after_search}, after an "
          f"f32 encoder forward and a k-means fit {kept}; top hits {seen}")
    check(after_search is True and kept is True, "6d (0): the port changed allow_tf32")
    check(seen == ["c0", "c0"], f"6d (0): top hits {seen}")


def mesh_main_path(seed: int, part: str, ring: dict, embedder) -> dict:
    """6d: (0)-(h) above, each part's wall time printed. Returns the main
    path's launches by kernel name."""
    launches: dict[str, int] = {}

    def add(counts: dict) -> None:
        for k, v in counts.items():
            if isinstance(v, int):
                launches[k] = launches.get(k, 0) + v

    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        parts = [("(0)", lambda: tf32_kept(seed)),
                 ("(a)", lambda: mesh_encoder_steps(seed)),
                 ("(b)", lambda: mesh_moe_steps(seed)),
                 ("(c)", lambda: mesh_lm_steps(seed)),
                 ("(d)", lambda: add(mesh_pp_forward(seed, part))),
                 ("(e)", lambda: add(mesh_ep_forwards(seed))),
                 ("(f)", lambda: add(mesh_sp_tp(ring, embedder))),
                 ("(g)", lambda: mesh_train_embedder(seed, root)),
                 ("(h)", lambda: add(mesh_dryrun()))]
        for name, fn in parts:
            t0 = time.perf_counter()
            fn()
            torch.cuda.empty_cache()
            print(f"  {name} {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    phase("1 environment")
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this script needs an H100", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    part = "pcie" if "pcie" in name.lower() else "sxm"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name} ({part}); "
          f"{os.cpu_count()} host cores, {torch.get_num_threads()} torch threads")
    t_start = time.perf_counter()

    phase("2 build")
    build_all()

    phase("2b the index's tier warm-up")
    warm2b = tier_warm_up(args.seed, smi)

    phase("2c the ring's plans")
    ivf_plan_table()

    phase("3 kernel vs plain, top-k")
    err3 = kernel_cases(args.seed)

    phase("3x kernel vs plain, any query count and k above 1024")
    err3x = query_k_cases(args.seed)

    phase("3b kernel vs plain, attention")
    err3b = attention_cases(args.seed)

    phase("3e kernel vs plain, the ring hop")
    err3e = stats_cases(args.seed)

    phase("3c kernel vs plain, IVF")
    err3c = ivf_kernel_cases(args.seed)

    phase("3f kernel vs plain, IVF: any block_rows and alignment, wide rows")
    err3f = ivf_repair_cases(args.seed)

    phase("3d kernel vs plain, per-block")
    err3d = blocks_kernel_cases(args.seed)

    phase("4 main path, small corpus")
    launches4, err4 = small_corpus(args.seed)

    phase("4b main path, small corpus, encoder")
    enc, err4b = encoder_corpus(args.seed)

    phase("4c main path, small corpus, IVF")
    launches4c, err4c = small_corpus_ivf(args.seed)

    phase("4d main path, small corpus, long documents")
    long4d = long_corpus(args.seed, enc["embedder"])

    phase("4e main path, small corpus, a pretrained BERT-family checkpoint")
    bert4e = bert_corpus(args.seed, smi)

    phase("4f main path, ingest through the staged builder")
    ingest4f = ingest_corpus(args.seed, smi)

    phase("4g memory and toolkits")
    mem4g = memory_and_toolkits(args.seed, smi, part)

    phase("4h agents from configs: orchestrators, environments, the trajectory store")
    team4h = team_agents(args.seed, smi)

    phase("4i the API on the card")
    api4i = api_on_card(args.seed, smi)

    phase("4j the DTR Excel agent and the eval harness on the card")
    dtr4j = dtr_and_eval(args.seed, smi, api4i)
    del api4i["twin_kb"]  # 5f holds its sharded KB against api4i["kb"]

    phase("4k the MCP tool server on the card")
    mcp4k = mcp_on_card(args.seed, smi)

    phase("5 main path, full size")
    full, keep5 = full_size(args.seed, part)

    phase("5c main path, full size, IVF")
    full_ivf, keep5c = full_size_ivf(args.seed, part)

    phase("5d ops path, full size, per-block")
    full_blocks = ops_full_size(part, keep5, keep5c)
    del keep5, keep5c
    torch.cuda.empty_cache()

    phase("5f main path, full size, sharded over a mesh")
    sharded5f = sharded_main_path(args.seed, part, smi, full, full_ivf, api4i.pop("kb"))
    del full["data"], full_ivf["data"]  # and with them phase 5's and 5c's indexes
    torch.cuda.empty_cache()

    phase("5b main path, full size, encoder")
    enc_full = encoder_full_size(args.seed, part, enc["embedder"])

    phase("5e main path, full size, the ring")
    ring = ring_full_size(args.seed, part, long4d["embedder"])

    phase("6a the local LLM: the agentic CLI on yrt_tiny_chat")
    chat6a = agentic_cli(args.seed)

    phase("6b the local LLM: Qwen2-0.5B widths")
    qwen2_width(args.seed, part)

    phase("6c training on the card")
    train6c = training_on_card(args.seed, part)

    phase("6d training and inference over a mesh")
    mesh6d = mesh_main_path(args.seed, part, ring, long4d["embedder"])

    phase("7 summary")
    kernels = []
    for tier in TIERS:
        kname, f = KERNEL_NAMES[tier], full[tier]
        kernels.append({
            "name": kname,
            "route": "cuda",
            # the ring's topk_pruned_<tier> entry (csrc/ivf_topk_<tier>.cu)
            "source": "youtu_rag_tpu_torch/csrc/ivf_scan_tma.cuh",
            "replaces": REPLACES[kname],
            "launches": (launches4[tier] + f["launches"]
                         + (chat6a["launches"] + ingest4f["launches"]["topk_pruned"]
                            + mem4g["launches"] + team4h["launches"] + api4i["launches"]
                            + dtr4j["topk_pruned"] + mcp4k["launches"]
                            + train6c["topk_pruned"]
                            if tier == "bfloat16" else 0)
                         + (dtr4j["topk_int8_pruned"] if tier == "int8" else 0)
                         + sharded5f["launches"].get(kname, 0) + mesh6d.get(kname, 0)
                         + warm2b["launches"].get(tier, 0)),
            "max_abs_err": max(err3[tier], err3x[kname], err4[tier], f["err"],
                               *(s["err"] for key, s in full["shapes"].items()
                                 if key.startswith(tier + " "))),
            "ms": f["ms"],
            "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"],
            "library_ms": f["library_ms"],
        })
    for kname in ATTENTION_NAMES:
        f = enc_full[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "youtu_rag_tpu_torch/csrc/attention.cu",
            "replaces": REPLACES[kname],
            "launches": (enc["launches"][kname] + f["launches"]
                         + (bert4e["launches"] + ingest4f["launches"]["blockwise_attention"]
                            + train6c["blockwise_attention"]
                            + sharded5f["launches"].get(kname, 0)
                            if kname == "blockwise_attention" else 0)
                         + mesh6d.get(kname, 0)),
            "max_abs_err": max(err3b[kname], f["err"],
                               bert4e["errs"]["attention"] if kname == "blockwise_attention"
                               else 0.0),
            "ms": f["ms"],
            "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"],
            "library_ms": f["library_ms"],
        })
    for tier in TIERS:
        kname, f = IVF_NAMES[tier], full_ivf[tier]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "youtu_rag_tpu_torch/csrc/ivf_scan_tma.cuh",
            "replaces": REPLACES[kname],
            "launches": (launches4c[tier] + f["launches"] + sharded5f["launches"].get(kname, 0)
                         + mesh6d.get(kname, 0)),
            "max_abs_err": max(err3c[tier], err3x[kname], err3f[kname], err4c[tier], f["err"]),
            "ms": f["ms"],
            "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"],
            "library_ms": None,  # no one PyTorch call computes a top-k over gathered blocks
        })
    for kname in BLOCKS_NAMES:
        f = full_blocks[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            # the merged calls: the ring's topk_merged_* and ivf_blocks_*
            # entries (the candidates stay on csrc/topk_blocks.cu)
            "source": "youtu_rag_tpu_torch/csrc/ivf_scan_tma.cuh",
            "replaces": REPLACES[kname],
            "launches": f["launches"] + mesh6d.get(kname, 0),
            "max_abs_err": max(err3d[kname], err3x[kname], err3f.get(kname, 0.0), f["err"]),
            "ms": f["ms"],
            "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"],
            "library_ms": f["library_ms"],  # null for IVF, as above
        })
    kernels.append({
        "name": "flash_attention_stats",
        "route": "cuda",
        "source": "youtu_rag_tpu_torch/csrc/attention_wgmma.cuh",
        "replaces": REPLACES["flash_attention_stats"],
        "launches": long4d["launches"] + ring["launches"] + mesh6d["flash_attention_stats"],
        "max_abs_err": max(err3e, ring["err"]),
        "ms": ring["ms"],
        "plain_ms": ring["plain_ms"],
        "bound_ms": ring["bound_ms"],
        "bound_by": ring["bound_by"],
        "library_ms": ring["library_ms"],
    })
    print(f"encoder KB max differences: (a) {err4b['a']}, (b) {err4b['b']}; BERT-base "
          f"(4e): {bert4e['errs']}; ingest encoder (4f): {ingest4f['errs']}")
    print(f"phases 2-6: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
