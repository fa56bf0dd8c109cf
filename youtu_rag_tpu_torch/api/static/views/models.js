// Models view: interactive embed / rerank testers over the service
// endpoints (counterpart of the reference's embedding/reranker test
// routes + settings surface: utu/rag/api/routes/embedding.py:EmbedTest,
// routes/reranker.py — exercised from the SPA instead of curl).

import { api, guard, h, t } from "../app.js";

export async function renderModels(view) {
  // ---------------------------------------------------------- embedder
  const embIn = h("textarea", { rows: "3", placeholder: t("models.embed_ph") });
  const embBtn = h("button", { class: "primary" }, t("models.embed_btn"));
  const embOut = h("div", { class: "dim" });
  embBtn.addEventListener("click", guard(async () => {
    const texts = embIn.value.split("\n").map((s) => s.trim()).filter(Boolean);
    if (!texts.length) return;
    const t0 = performance.now();
    const r = await api("/api/embedding/embed", {
      method: "POST", body: JSON.stringify({ texts }),
    });
    const ms = (performance.now() - t0).toFixed(1);
    embOut.innerHTML = "";
    const vecs = r.embeddings || [];
    embOut.appendChild(h("div", {},
      `${vecs.length} embedding(s) · dim ${vecs[0] ? vecs[0].length : 0} · ${ms} ms`));
    vecs.forEach((v, i) => {
      const norm = Math.sqrt(v.reduce((a, x) => a + x * x, 0)).toFixed(4);
      const head = v.slice(0, 6).map((x) => x.toFixed(3)).join(", ");
      embOut.appendChild(h("div", { class: "mono dim" },
        `[${i}] ‖v‖=${norm} · [${head}, …]`));
    });
  }));

  // ---------------------------------------------------------- reranker
  const rrQuery = h("input", { placeholder: t("models.rerank_q_ph") });
  const rrDocs = h("textarea", { rows: "4", placeholder: t("models.rerank_d_ph") });
  const rrBtn = h("button", { class: "primary" }, t("models.rerank_btn"));
  const rrOut = h("div", {});
  rrBtn.addEventListener("click", guard(async () => {
    const documents = rrDocs.value.split("\n").map((s) => s.trim()).filter(Boolean);
    if (!rrQuery.value.trim() || !documents.length) return;
    const r = await api("/api/reranker/rerank", {
      method: "POST",
      body: JSON.stringify({ query: rrQuery.value.trim(), documents }),
    });
    rrOut.innerHTML = "";
    (r.results || []).forEach((res, i) => {
      rrOut.appendChild(h("div", { class: "row", style: "gap:8px" },
        h("span", { class: "badge" }, `#${i + 1}`),
        h("span", { class: "badge ok" }, Number(res.relevance_score).toFixed(4)),
        h("span", {}, (res.document || "").slice(0, 120))));
    });
  }));

  view.appendChild(h("div", { class: "col", style: "max-width:860px" },
    h("div", { class: "card col" },
      h("h3", {}, t("models.embed_title")), embIn,
      h("div", { class: "row" }, embBtn), embOut),
    h("div", { class: "card col" },
      h("h3", {}, t("models.rerank_title")), rrQuery, rrDocs,
      h("div", { class: "row" }, rrBtn), rrOut),
  ));
}
