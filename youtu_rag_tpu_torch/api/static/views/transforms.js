// Pure view transforms: data → display models, no DOM, no fetch, no Date,
// no imports. Every function here is executed BOTH by the browser (imported
// from the view modules) and by pytest through the restricted-JS interpreter
// (youtu_rag_tpu/utils/jsmini.py, tests/api/test_js_transforms.py) — keep it
// inside the jsmini subset (no classes/async/switch/Date/Set/Map literals in
// exported paths) so a broken render transform fails a hermetic test instead
// of a user. Counterpart of the human-click verification rag_webui gets.

// ------------------------------------------------------------- formatting

export function escapeHtml(s) {
  return String(s)
    .replaceAll("&", "&amp;").replaceAll("<", "&lt;").replaceAll(">", "&gt;")
    .replaceAll('"', "&quot;").replaceAll("'", "&#39;");
}

export function fmtBytes(n) {
  if (!n && n !== 0) return "";
  if (n < 1024) return `${n} B`;
  if (n < 1024 * 1024) return `${(n / 1024).toFixed(1)} KB`;
  if (n < 1024 * 1024 * 1024) return `${(n / 1024 / 1024).toFixed(1)} MB`;
  return `${(n / 1024 / 1024 / 1024).toFixed(2)} GB`;
}

export function fmtValue(v, unit = "") {
  return `${typeof v === "number" && v % 1 ? v.toFixed(1) : v}${unit}`;
}

export function clamp01(v, fallback = 0.5) {
  const a = parseFloat(v);
  return Number.isFinite(a) ? Math.min(Math.max(a, 0), 1) : fallback;
}

export function excerpt(s, n) {
  const text = s || "";
  return text.slice(0, n) + (text.length > n ? "…" : "");
}

// ------------------------------------------------------------------- csv
//
// Quote-aware CSV row parser ("" escapes a quote inside a quoted field;
// commas/newlines inside quotes don't split — ref chat.js
// renderCSVInSidebar handles the same grammar before tabling).

export function parseCsv(text, maxRows = 500) {
  const rows = [];
  let field = "", row = [], inQuotes = false;
  const push = () => { row.push(field); field = ""; };
  const endRow = () => {
    push();
    if (row.length > 1 || row[0] !== "") rows.push(row);
    row = [];
  };
  for (let i = 0; i < text.length && rows.length < maxRows; i++) {
    const c = text[i];
    if (inQuotes) {
      if (c === '"') {
        if (text[i + 1] === '"') { field += '"'; i++; } else inQuotes = false;
      } else field += c;
    } else if (c === '"') inQuotes = true;
    else if (c === ",") push();
    else if (c === "\n") endRow();
    else if (c !== "\r") field += c;
  }
  if (field || row.length) endRow();
  return rows;
}

// ------------------------------------------------------------- markdown
//
// Escape-first renderer → HTML string: the input is escaped wholesale, then
// block structure (fences, headings, tables, lists, quotes, rules) and
// inline marks (code, bold, italic, http links) are layered on the escaped
// text. No raw HTML ever passes through — XSS-safety is the invariant the
// Python-side golden tests pin (ref markdown-utils.js renders chat answers
// the same way).

const INLINE_RULES = [
  // \x60 = backtick (kept out of regex literals — lexer-tool ambiguity)
  [/\x60([^\x60]+)\x60/g, (_, c) => `<code>${c}</code>`],
  [/\*\*([^*]+)\*\*/g, (_, c) => `<strong>${c}</strong>`],
  [/(^|[^*])\*([^*\s][^*]*)\*/g, (p, pre, c) => `${pre}<em>${c}</em>`],
  // links: only http(s) URLs, and the href is the escaped URL itself
  [/\[([^\]]+)\]\((https?:\/\/[^)\s]+)\)/g,
    (_, text, url) => `<a href="${url}" target="_blank" rel="noopener">${text}</a>`],
];

function inline(escaped) {
  let out = escaped;
  for (const [re, sub] of INLINE_RULES) out = out.replace(re, sub);
  return out;
}

function isTableRow(line) {
  return /^\s*\|.*\|\s*$/.test(line);
}

function splitRow(line) {
  const cells = line.trim().replace(/^\|/, "").replace(/\|$/, "").split("|");
  return cells.map((c) => c.trim());
}

export function markdownToHtml(text) {
  const lines = escapeHtml(text || "").split("\n");
  let html = "";
  let i = 0;
  let para = [];

  const flushPara = () => {
    if (para.length) {
      html += `<p>${inline(para.join("<br>"))}</p>`;
      para = [];
    }
  };

  while (i < lines.length) {
    const line = lines[i];

    if (/^\s*\x60\x60\x60/.test(line)) {  // fenced code block
      flushPara();
      const buf = [];
      i += 1;
      while (i < lines.length && !/^\s*\x60\x60\x60/.test(lines[i])) { buf.push(lines[i]); i += 1; }
      i += 1; // closing fence (or EOF)
      html += `<pre><code>${buf.join("\n")}</code></pre>`;
      continue;
    }

    if (isTableRow(line) && i + 1 < lines.length
        && /^\s*\|[\s:|-]+\|\s*$/.test(lines[i + 1])) {   // table
      flushPara();
      const head = splitRow(line);
      i += 2;
      const body = [];
      while (i < lines.length && isTableRow(lines[i])) { body.push(splitRow(lines[i])); i += 1; }
      html += "<table><thead><tr>"
        + head.map((c) => `<th>${inline(c)}</th>`).join("")
        + "</tr></thead><tbody>"
        + body.map((r) => `<tr>${r.map((c) => `<td>${inline(c)}</td>`).join("")}</tr>`).join("")
        + "</tbody></table>";
      continue;
    }

    const hm = line.match(/^(#{1,4})\s+(.*)$/);           // heading
    if (hm) {
      flushPara();
      const lvl = hm[1].length;
      html += `<h${lvl + 2}>${inline(hm[2])}</h${lvl + 2}>`;  // h3..h6: stay below app h2
      i += 1;
      continue;
    }

    if (/^\s*(---+|\*\*\*+)\s*$/.test(line)) {            // rule
      flushPara(); html += "<hr>"; i += 1; continue;
    }

    if (/^\s*&gt;\s?/.test(line)) {                       // blockquote (escaped >)
      flushPara();
      const buf = [];
      while (i < lines.length && /^\s*&gt;\s?/.test(lines[i])) {
        buf.push(lines[i].replace(/^\s*&gt;\s?/, "")); i += 1;
      }
      html += `<blockquote>${inline(buf.join("<br>"))}</blockquote>`;
      continue;
    }

    const ul = line.match(/^\s*[-*]\s+(.*)$/);            // lists (flat)
    const ol = line.match(/^\s*\d+[.)]\s+(.*)$/);
    if (ul || ol) {
      flushPara();
      const tag = ul ? "ul" : "ol";
      const pat = ul ? /^\s*[-*]\s+(.*)$/ : /^\s*\d+[.)]\s+(.*)$/;
      const items = [];
      while (i < lines.length) {
        const m = lines[i].match(pat);
        if (!m) break;
        items.push(`<li>${inline(m[1])}</li>`); i += 1;
      }
      html += `<${tag}>${items.join("")}</${tag}>`;
      continue;
    }

    if (!line.trim()) { flushPara(); i += 1; continue; }  // blank = paragraph break
    para.push(line); i += 1;
  }
  flushPara();
  return html;
}

// ------------------------------------------------------------------ diff
//
// Word-level LCS diff — expected vs executed answer on the QA-detail page.
// Returns [[cls, text], …] segments (cls: diff-del | diff-ins | diff-same).

export function diffWords(expected, actual) {
  const a = (expected || "").split(/\s+/).filter(Boolean);
  const b = (actual || "").split(/\s+/).filter(Boolean);
  const n = a.length, m = b.length;
  const L = [];
  for (let i = 0; i <= n; i++) L.push(new Array(m + 1).fill(0));
  for (let i = n - 1; i >= 0; i--) {
    for (let j = m - 1; j >= 0; j--) {
      L[i][j] = a[i] === b[j] ? L[i + 1][j + 1] + 1 : Math.max(L[i + 1][j], L[i][j + 1]);
    }
  }
  const segs = [];
  const push = (cls, words) => {
    if (words.length) segs.push([cls, words.join(" ") + " "]);
  };
  let i = 0, j = 0;
  let del = [], ins = [], same = [];
  while (i < n && j < m) {
    if (a[i] === b[j]) {
      if (del.length || ins.length) { push("diff-del", del); push("diff-ins", ins); del = []; ins = []; }
      same.push(a[i]); i++; j++;
    } else {
      if (same.length) { push("diff-same", same); same = []; }
      if (L[i + 1][j] >= L[i][j + 1]) { del.push(a[i]); i++; }
      else { ins.push(b[j]); j++; }
    }
  }
  del = del.concat(a.slice(i));
  ins = ins.concat(b.slice(j));
  push("diff-del", del); push("diff-ins", ins); push("diff-same", same);
  return segs;
}

// ----------------------------------------------------------------- charts
//
// Geometry for the SVG line chart: path + grid + min/max direct labels.
// The DOM layer (views/utils.js lineChart) only places these numbers.

export function chartGeometry(points, { width = 560, height = 120, unit = "ms" } = {}) {
  if (points.length < 2) return null;
  const PAD = { l: 6, r: 6, t: 10, b: 6 };
  const w = width - PAD.l - PAD.r, hgt = height - PAD.t - PAD.b;
  const vals = points.map((p) => p.value);
  let vmax = vals[0], vmin = vals[0];
  for (const v of vals) { if (v > vmax) vmax = v; if (v < vmin) vmin = v; }
  const span = vmax - vmin || 1;
  const x = (i) => PAD.l + (i / (points.length - 1)) * w;
  const y = (v) => PAD.t + (1 - (v - vmin) / span) * hgt;
  const path = points.map((p, i) => `${i ? "L" : "M"}${x(i).toFixed(1)},${y(p.value).toFixed(1)}`).join(" ");
  const grid = [0.25, 0.5, 0.75].map((f) => PAD.t + f * hgt);
  const labels = [vmax, vmin].map((v) => {
    const idx = vals.indexOf(v);
    return {
      x: Math.min(Math.max(x(idx), PAD.l + 14), width - 40),
      y: v === vmax ? Math.max(y(v) - 4, 9) : Math.min(y(v) + 11, height - 2),
      text: `${v % 1 ? v.toFixed(1) : v}${unit}`,
    };
  });
  return { path, grid, labels, pad: PAD, x0: PAD.l, plotWidth: w };
}

// Rows for the horizontal bar chart: pct widths + direct-labeled values.
export function barRows(rows, { unit = "", max = null } = {}) {
  let m = max;
  if (!m) {
    m = 1;
    for (const r of rows) if (r.value > m) m = r.value;
  }
  return rows.map((r) => ({
    label: r.label,
    pct: Math.max((r.value / m) * 100, 0.5),
    value: fmtValue(r.value, unit),
    hint: r.hint || `${r.label}: ${r.value}${unit}`,
  }));
}

// ------------------------------------------------------------------- chat

// Split "## Context N (Relevance: x)" retrieval blocks out of an answer
// into collapsible source cards; the preamble stays the main answer body.
export function splitContexts(text) {
  if (!/^## Context \d+[^\n]*$/m.test(text)) return { body: text, sources: [] };
  const parts = text.split(/^(## Context \d+[^\n]*)$/m);
  const body = parts[0].trim();
  const sources = [];
  for (let i = 1; i + 1 < parts.length; i += 2) {
    sources.push({ title: parts[i].replace(/^## /, ""), content: parts[i + 1].trim() });
  }
  return { body, sources };
}

// Pull the source filename out of a retrieval context block's metadata
// line ("**Metadata:** source=report.md, file_type=md").
export function sourceFileOf(content) {
  const m = /\bsource=([^\s,]+)/.exec(content || "");
  return m ? m[1] : null;
}

// File-sidebar dispatch: extension → renderer kind (ref chat.js
// openChatFileSidebar's type switch, 2138-2533).
const IMG_EXTS = [".png", ".jpg", ".jpeg", ".gif", ".webp", ".svg", ".bmp"];

export function sidebarKind(name) {
  const m = (name || "").match(/\.[^.]+$/);
  const ext = m ? m[0].toLowerCase() : "";
  if (IMG_EXTS.includes(ext)) return "image";
  if (ext === ".csv") return "csv";
  if (ext === ".md" || ext === ".markdown") return "markdown";
  if (ext === ".json" || ext === ".jsonl") return "json";
  return "text";
}

// Workflow-update card: nodes → display rows with status icons.
const WF_ICONS = { pending: "○", running: "◐", done: "●", failed: "✗" };

export function workflowNodes(data) {
  return ((data && data.nodes) || []).map((n) => ({
    icon: WF_ICONS[n.status] || "○",
    agent: n.agent,
    task: n.task,
    status: n.status,
  }));
}

// Parallel-orchestrator window key + status line.
export function pwinKey(d) {
  return `${(d && d.group) ?? 0}:${(d && d.task_idx) ?? 0}`;
}

export function pwinStatusText(d) {
  if (d.status === "start") return "⏳";
  if (d.status === "done") {
    return d.duration_ms ? `✓ ${(d.duration_ms / 1000).toFixed(1)}s` : "✓";
  }
  return "✗";
}

// --------------------------------------------------------------- kb: list

export function filterKbs(kbs, query) {
  const q = (query || "").trim().toLowerCase();
  return (kbs || []).filter((kb) =>
    !q || kb.name.toLowerCase().includes(q) ||
    (kb.description || "").toLowerCase().includes(q));
}

export function kbCardModel(kb, chunksLabel = "chunks") {
  const badges = [{ cls: "badge", text: kb.backend }];
  if (kb.storage_dtype && kb.storage_dtype !== "bfloat16") {
    badges.push({ cls: "badge warn", text: kb.storage_dtype });
  }
  return {
    name: kb.name,
    badges,
    description: kb.description || "",
    summary: `${kb.chunks} ${chunksLabel} · ${kb.embedder}`,
  };
}

// Create-modal body: advanced knobs map to per-KB config overrides
// (storage tier → vector_store.index.storage_dtype, fusion weight →
// retriever.hybrid_alpha; defaults are omitted so the server config wins).
export function kbCreateBody(name, description, tier, alphaStr) {
  const body = { name };
  if ((description || "").trim()) body.description = description.trim();
  const config = {};
  if (tier) config.vector_store = { index: { storage_dtype: tier } };
  const alpha = parseFloat(alphaStr);
  if (!Number.isNaN(alpha) && alpha !== 0.5) config.retriever = { hybrid_alpha: alpha };
  if (Object.keys(config).length) body.config = config;
  return body;
}

// Query-tester request body: clamped hybrid alpha only in hybrid mode.
export function queryRequestBody(query, topKStr, mode, alphaStr) {
  const body = { query: (query || "").trim(), top_k: parseInt(topKStr), mode };
  if (mode === "hybrid") body.hybrid_alpha = clamp01(alphaStr);
  return body;
}

// --------------------------------------------------------------- kb: build

// Per-source build drill-down: detail.progress is the append-only event
// stream [{source, status, done, total}] — reduce to the latest state per
// source, in first-seen order (ref rag_webui build screen source rows).
export function buildDrilldown(log) {
  const events = (log.detail && log.detail.progress) || [];
  const order = [];
  const last = {};
  for (const ev of events) {
    if (!(ev.source in last)) order.push(ev.source);
    last[ev.source] = ev;
  }
  const rows = order.map((src) => {
    const ev = last[src];
    const cls = ev.status === "completed" ? "ok" : ev.status === "failed" ? "err" : "warn";
    return { source: src, status: ev.status, cls, progress: `${ev.done}/${ev.total}` };
  });
  const errors = (log.detail && log.detail.errors) || [];
  const summary = log.detail
    ? `${log.detail.processed_documents} docs · ${log.detail.total_chunks} chunks`
    : "";
  return { rows, errors, summary };
}

// Build-log table rows: newest 10 first, status → badge class, error strip.
export function buildLogRows(logs) {
  return (logs || []).slice(-10).reverse().map((l) => ({
    time: l.time,
    status: l.status,
    cls: l.status === "completed" ? "ok" : l.status === "running" ? "warn" : "err",
    result: l.detail ? `${l.detail.processed_documents} docs · ${l.detail.total_chunks} chunks` : "",
    errors: l.detail && l.detail.errors && l.detail.errors.length
      ? l.detail.errors.join("; ").slice(0, 140) : "",
  }));
}

// One-line build report: status + counts + skip/table annotations.
export function buildReportSummary(r) {
  const rep = r.report || {};
  return `${r.status.processed_documents} docs → ${r.status.total_chunks} chunks`
    + (rep.skipped ? ` · ${rep.skipped} unchanged (skipped)` : "")
    + (rep.tables && rep.tables.length ? ` · tables: ${rep.tables.join(", ")}` : "");
}

// File-picker page model: search-filtered (dotfile-hidden), paginated,
// selection-aware (ref knowledge-base-detail.js renderFileModalPagination).
export function filePickerPage(files, query, page, pageSize, pendingNames) {
  const q = (query || "").trim().toLowerCase();
  const visible = (files || []).filter((f) => !f.name.startsWith(".meta") &&
    (!q || f.name.toLowerCase().includes(q)));
  const pages = Math.max(1, Math.ceil(visible.length / pageSize));
  const p = Math.min(page, pages - 1);
  const shown = visible.slice(p * pageSize, (p + 1) * pageSize);
  const isPending = (n) => (pendingNames || []).indexOf(n) >= 0;
  return {
    page: p,
    pages,
    pager: `${p + 1}/${pages}`,
    rows: shown.map((f) => ({ name: f.name, size: fmtBytes(f.size), checked: isPending(f.name) })),
    allChecked: shown.length > 0 && shown.every((f) => isPending(f.name)),
  };
}

// ------------------------------------------------------------- kb: qa

const QA_STATUS_CLS = { completed: "ok", failed: "err" };

export function qaStatusCls(status) {
  return QA_STATUS_CLS[status] || "";
}

export function qaRows(pairs) {
  return (pairs || []).map((p) => ({
    id: p.id,
    question: p.question,
    answer: (p.answer || "").slice(0, 100),
    status: p.learning_status || "pending",
    cls: qaStatusCls(p.learning_status),
    source: p.source_id,
  }));
}

export function qaAskResult(r) {
  if (r.matched) {
    return { matched: true, badge: `match ${r.matched.score.toFixed(3)}`, answer: r.matched.answer };
  }
  const best = r.candidates && r.candidates.length ? r.candidates[0].score.toFixed(3) : "n/a";
  return { matched: false, text: `no QA match above threshold (best: ${best})` };
}

// Execution history: stored JSON (or legacy text) → rows; bad JSON must
// degrade to an empty history, never a crash.
export function qaHistoryRows(p) {
  let parsed = [];
  try {
    parsed = JSON.parse(p.executed_results);
    if (!Array.isArray(parsed)) parsed = [];
  } catch (e) { parsed = []; }
  return parsed.map((x) => ({
    agent: x.agent,
    cls: x.success ? "badge ok" : "badge err",
    body: x.success ? (x.answer || "(empty)") : (x.error || "failed"),
    success: !!x.success,
  }));
}

export function qaDetailMetaLine(p) {
  return `id: ${p.id} · source: ${p.source_id}`
    + (p.related_file ? ` · file: ${p.related_file}` : "")
    + (p.executed_at ? ` · executed: ${p.executed_at}` : "");
}

// ------------------------------------------------------------- kb: chunks

export function chunkRows(chunks) {
  return (chunks || []).map((c) => ({
    key: `${c.document_id}#${c.chunk_index}`,
    excerpt: c.content.slice(0, 140),
    index: (c.metadata && c.metadata.index_type) || "",
  }));
}

export function chunkStatsLine(data, offset) {
  return `${data.matched} matched of ${data.total} · rows ${offset}–${offset + data.chunks.length}`;
}

// ------------------------------------------------------------- kb: tables

export function tableRows(tables) {
  return (tables || []).map((tb) => ({
    name: tb.table_name,
    source: tb.source,
    size: `${tb.n_rows}×${tb.n_cols}`,
    columns: (tb.columns || "").slice(0, 80),
  }));
}

export function sqlResultModel(r) {
  if (!r.columns || !r.columns.length) return null;
  return {
    columns: r.columns.map((c) => String(c)),
    rows: r.rows.map((row) => row.map((v) => (v === null || v === undefined ? "" : String(v)))),
  };
}

// ----------------------------------------------------------------- monitor

// Aggregate tiles + per-KB chart rows from /api/monitor/metrics.
export function metricsSummary(metrics) {
  const perKb = Object.entries((metrics && metrics.metrics) || {});
  if (!perKb.length) return null;
  let totChunks = 0, totBytes = 0, totQueries = 0, totErrors = 0;
  for (const [, m] of perKb) {
    totChunks += m.total_chunks || 0;
    totBytes += m.index_size_bytes || 0;
    totQueries += m.query_count || 0;
    totErrors += m.error_count || 0;
  }
  const chunkRows = perKb.map(([name, m]) => ({ label: name, value: m.total_chunks || 0 }));
  const latencyRows = perKb
    .filter(([, m]) => (m.query_count || 0) > 0)
    .map(([name, m]) => ({
      label: name,
      value: Math.round((m.p95_latency_ms || 0) * 10) / 10,
      hint: `${name}: p50 ${Math.round(m.p50_latency_ms || 0)} ms · p95 ${Math.round(m.p95_latency_ms || 0)} ms · ${m.query_count} queries`,
    }));
  const lexRows = perKb
    .filter(([, m]) => m.lexical_index)
    .map(([name, m]) => ({
      label: name,
      value: m.lexical_index.terms || 0,
      hint: `${name}: ${m.lexical_index.documents} docs · `
        + `${m.lexical_index.terms} terms · `
        + `${m.lexical_index.total_tokens} tokens`,
    }));
  return {
    tiles: [
      { label: "chunks", value: totChunks },
      { label: "index size", value: fmtBytes(totBytes) },
      { label: "queries (24h)", value: totQueries },
      { label: "errors", value: totErrors },
    ],
    chunkRows,
    latencyRows,
    lexRows,
  };
}

// Query-count-weighted mean latency across stores (the live chart sample);
// null when no queries have been recorded yet.
export function weightedAvgLatency(metrics) {
  const entries = Object.values((metrics && metrics.metrics) || {});
  let q = 0, acc = 0;
  for (const x of entries) {
    q += x.query_count || 0;
    acc += (x.avg_latency_ms || 0) * (x.query_count || 0);
  }
  if (!q) return null;
  return Math.round((acc / q) * 100) / 100;
}

export function healthSummary(health) {
  return {
    overallCls: health.overall_healthy ? "ok" : "err",
    overallText: `${health.healthy_backends}/${health.total_backends} healthy`,
    backends: Object.entries(health.backends || {}).map(([name, ok]) => ({
      name,
      cls: ok ? "ok" : "err",
      text: ok ? "healthy" : "unhealthy",
    })),
  };
}

// ------------------------------------------------------------------ memory

export function memoryRow(m) {
  const skill = m.memory_type === "procedural" && m.use_count
    ? ` · ${m.use_count} uses, ${Math.round(m.success_rate * 100)}% ok` : "";
  return {
    id: m.id,
    type: m.memory_type,
    content: excerpt(m.content, 180),
    signals: (m.score !== undefined ? `score ${m.score} · ` : "")
      + `imp ${m.importance.toFixed(2)}${skill}`,
    createdAt: m.created_at,
  };
}

export function memoryTiles(stats, types) {
  const s = stats || {};
  const tiles = [{ label: "total", value: s.total ?? 0 }];
  for (const type of types) tiles.push({ label: type, value: s[type] ?? 0 });
  return tiles;
}

export function pagerText(page, total, pageSize) {
  const pages = Math.max(1, Math.ceil((total || 0) / pageSize));
  return `${Math.min(page + 1, pages)}/${pages}`;
}

// ------------------------------------------------------------------- files

export function fileRows(files, query) {
  const q = (query || "").trim().toLowerCase();
  return (files || [])
    .filter((f) => !f.name.startsWith(".meta") && (!q || f.name.toLowerCase().includes(q)))
    .map((f) => ({
      name: f.name,
      size: fmtBytes(f.size),
      mtime: f.mtime,
      stages: f.stages || null,
    }));
}

// Upload-stage progress line: stages [{stage, status}] → "parse ✓ · ocr ⏳".
export function uploadStageLine(stages) {
  const MARK = { completed: "✓", running: "⏳", failed: "✗", pending: "·" };
  return (stages || [])
    .map((s) => `${s.stage} ${MARK[s.status] || "·"}`)
    .join(" · ");
}
