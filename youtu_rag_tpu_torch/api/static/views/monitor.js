// Monitor view: storage health + metrics dashboard (stat tiles + bar
// charts), embedding/reranker testers, recent trajectory runs.
// Counterpart of rag_webui's monitor screens + monitor_service HTML
// dashboard. Charts: single-measure horizontal bars (one hue — the
// accent — identity carried by row labels; values direct-labeled at the
// bar end in text ink; 2px gaps; no legend for a single series).

import { api, closeModal, guard, h, openModal, t } from "../app.js";
import { lineChart } from "./utils.js";
import {
  barRows, healthSummary, metricsSummary, weightedAvgLatency,
} from "./transforms.js";

// horizontal bar chart: rows = [{label, value, hint?}], one measure;
// widths/labels computed by transforms.barRows (pytest-golden-tested).
export function barChart(rows, opts = {}) {
  const box = h("div", { class: "chart" });
  for (const r of barRows(rows, opts)) {
    box.appendChild(h("div", { class: "chart-row", title: r.hint },
      h("span", { class: "chart-label" }, r.label),
      h("div", { class: "chart-track" },
        h("div", { class: "chart-bar", style: `width:${r.pct}%` })),
      h("span", { class: "chart-value" }, r.value)));
  }
  return box;
}

function statTile(label, value, sub = "") {
  return h("div", { class: "tile" },
    h("div", { class: "tile-value" }, String(value)),
    h("div", { class: "tile-label" }, label),
    sub ? h("div", { class: "dim" }, sub) : null);
}

export async function renderMonitor(view) {
  const healthBox = h("div", { class: "grid" });
  const metricsBox = h("div", {});
  const runsBox = h("div", {});
  const liveBox = h("div", {});

  // live latency time series: poll metrics, roll the last 60 samples of
  // the query-weighted average latency across stores; the interval dies
  // with the view (document.contains check) so route changes don't leak
  const liveSeries = [];
  async function sampleLatency() {
    if (!document.contains(liveBox)) { clearInterval(liveTimer); return; }
    try {
      const m = await api("/api/monitor/metrics");
      const avg = weightedAvgLatency(m);
      if (avg === null) return;
      liveSeries.push({ value: avg, label: new Date().toLocaleTimeString() });
      if (liveSeries.length > 60) liveSeries.shift();
      liveBox.innerHTML = "";
      liveBox.appendChild(lineChart(liveSeries, { unit: " ms" }));
    } catch { /* server away — keep polling */ }
  }
  const liveTimer = setInterval(sampleLatency, 3000);

  // embedding tester
  const embIn = h("textarea", { rows: "2", style: "flex:1", placeholder: "text to embed (one per line)" });
  const embBtn = h("button", {}, "Embed");
  const embOut = h("div", { class: "dim" });
  embBtn.addEventListener("click", guard(async () => {
    const texts = embIn.value.split("\n").map((s) => s.trim()).filter(Boolean);
    if (!texts.length) return;
    const t0 = performance.now();
    const r = await api("/api/embedding/embed", { method: "POST", body: JSON.stringify({ texts }) });
    embOut.textContent = `${r.embeddings.length} vectors · dim ${r.dimension} · ${(performance.now() - t0).toFixed(0)} ms` +
      ` · v[0][:4] = [${r.embeddings[0].slice(0, 4).map((x) => x.toFixed(4)).join(", ")}]`;
  }));

  // reranker tester
  const rrQuery = h("input", { placeholder: "query", style: "flex:1" });
  const rrDocs = h("textarea", { rows: "3", style: "width:100%", placeholder: "candidate documents (one per line)" });
  const rrBtn = h("button", {}, "Rerank");
  const rrOut = h("div", {});
  rrBtn.addEventListener("click", guard(async () => {
    const documents = rrDocs.value.split("\n").map((s) => s.trim()).filter(Boolean);
    if (!rrQuery.value.trim() || !documents.length) return;
    const r = await api("/api/reranker/rerank", {
      method: "POST", body: JSON.stringify({ query: rrQuery.value.trim(), documents }),
    });
    rrOut.innerHTML = "";
    for (const item of r.results) {
      rrOut.appendChild(h("div", { class: "row" },
        h("span", { class: "badge ok" }, item.relevance_score.toFixed(4)),
        h("span", {}, (item.document || "").slice(0, 120))));
    }
  }));

  view.appendChild(h("div", { class: "col" },
    h("div", { class: "card" }, h("h3", {}, t("monitor.health")), healthBox),
    h("div", { class: "card" }, h("h3", {}, t("monitor.metrics")), metricsBox),
    h("div", { class: "card" }, h("h3", {}, t("monitor.latency")), liveBox),
    h("div", { class: "card col" },
      h("h3", {}, t("monitor.embed")),
      h("div", { class: "row" }, embIn, embBtn), embOut,
      h("h3", {}, t("monitor.rerank")),
      h("div", { class: "row" }, rrQuery, rrBtn), rrDocs, rrOut),
    h("div", { class: "card" }, h("h3", {}, t("monitor.runs")), runsBox)));

  const [health, metrics] = await Promise.all([
    api("/api/monitor/health"), api("/api/monitor/metrics"),
  ]);
  const hs = healthSummary(health);
  healthBox.appendChild(h("div", { class: "card" },
    h("div", { class: "row" }, h("strong", {}, "overall"),
      h("span", { class: `badge ${hs.overallCls}` }, hs.overallText)),
    h("div", { class: "dim" }, health.checked_at || "")));
  for (const b of hs.backends) {
    healthBox.appendChild(h("div", { class: "card" },
      h("div", { class: "row" }, h("strong", {}, b.name),
        h("span", { class: `badge ${b.cls}` }, b.text))));
  }
  if (!Object.keys(health.backends || {}).length) {
    healthBox.appendChild(h("div", { class: "dim" }, "(no storage backends yet)"));
  }

  // metrics: aggregate tiles + per-KB bar charts (+ raw JSON in a modal)
  metricsBox.innerHTML = "";
  const ms = metricsSummary(metrics);
  if (!ms) {
    metricsBox.appendChild(h("div", { class: "dim" }, "(no metrics yet — build a knowledge base)"));
  } else {
    metricsBox.appendChild(h("div", { class: "row tiles" },
      ...ms.tiles.map((x) => statTile(x.label, x.value))));
    metricsBox.appendChild(h("h3", {}, "chunks per knowledge base"));
    metricsBox.appendChild(barChart(ms.chunkRows));
    if (ms.latencyRows.length) {
      metricsBox.appendChild(h("h3", {}, "query latency p95 (ms)"));
      metricsBox.appendChild(barChart(ms.latencyRows, { unit: " ms" }));
    }
    // hybrid retrieval's lexical side: BM25 inverted-index size per KB
    if (ms.lexRows.length) {
      metricsBox.appendChild(h("h3", {}, "BM25 index terms per knowledge base"));
      metricsBox.appendChild(barChart(ms.lexRows));
    }
    const rawBtn = h("button", { class: "ghost" }, "raw JSON");
    rawBtn.addEventListener("click", () => {
      openModal(h("div", {},
        h("h2", {}, "metrics"),
        h("pre", {}, JSON.stringify(metrics, null, 2)),
        h("button", { onclick: closeModal }, "close")));
    });
    metricsBox.appendChild(rawBtn);
  }

  try {
    const runs = await api("/api/trajectories?limit=10");
    if (!runs.available) {
      runsBox.appendChild(h("div", { class: "dim" }, "trajectory DB not configured (set YRT_DB_URL)"));
    } else if (!runs.trajectories.length) {
      runsBox.appendChild(h("div", { class: "dim" }, "(no runs yet)"));
    } else {
      const rows = runs.trajectories.map((r) =>
        h("tr", {},
          h("td", { class: "dim" }, new Date(r.created_at * 1000).toLocaleTimeString()),
          h("td", {}, (r.input || "").slice(0, 60)),
          h("td", { class: "dim" }, (r.output || r.error || "").slice(0, 80)),
          h("td", { class: "dim" }, `${(r.tool_calls || []).length}`)));
      runsBox.appendChild(h("table", {},
        h("tr", {}, h("th", {}, "time"), h("th", {}, "input"), h("th", {}, "output"), h("th", {}, "tools")),
        rows));
    }
  } catch { /* trajectories optional */ }
}
