// Knowledge-base views: list + detail (build screen with live log polling,
// paginated chunk browser, QA management + detail, index maintenance,
// metadata export/import, snapshots, retrieval tester).
// Counterpart of rag_webui's knowledge-base{,-detail}.js + qa-detail.js.

import { api, fmtBytes, guard, h, openModal, closeModal, state, t, toast } from "../app.js";
import { renderDiff, renderMarkdown } from "./utils.js";
import {
  buildDrilldown, buildLogRows, buildReportSummary, chunkRows, chunkStatsLine,
  filePickerPage, filterKbs, kbCardModel, kbCreateBody, qaAskResult,
  qaDetailMetaLine, qaHistoryRows, qaStatusCls, queryRequestBody,
  sqlResultModel, tableRows,
} from "./transforms.js";

export async function renderKb(view, hash) {
  const qa = hash.match(/^#\/kb\/([^/]+)\/qa\/(.+)$/);
  if (qa) return renderQaDetail(view, decodeURIComponent(qa[1]), decodeURIComponent(qa[2]));
  const m = hash.match(/^#\/kb\/([^/]+)/);
  if (m) return renderKbDetail(view, decodeURIComponent(m[1]));
  return renderKbList(view);
}

// ------------------------------------------------------------------ list

async function renderKbList(view) {
  const data = await api("/api/knowledge-bases");

  // Create modal with the advanced knobs the API accepts as per-KB config
  // overrides (ref knowledge-base.js create/edit modal: name, description,
  // engine options): storage tier → vector_store.index.storage_dtype,
  // dense/lexical fusion weight → retriever.hybrid_alpha.
  function openCreateModal() {
    const nameIn = h("input", { placeholder: t("kb.name") });
    const descIn = h("textarea", { rows: "2", placeholder: t("kb.desc"), style: "width:100%" });
    const tierSel = h("select", {},
      h("option", { value: "" }, "bfloat16 (default)"),
      h("option", { value: "int8" }, "int8 — 2× QPS"),
      h("option", { value: "int4" }, "int4 — 3× QPS, two-stage re-rank"));
    const alphaIn = h("input", { type: "number", min: "0", max: "1", step: "0.05", value: "0.5", style: "width:90px" });
    const okBtn = h("button", { class: "primary" }, t("kb.create"));
    const err = h("div", { class: "pwin-error" });
    okBtn.addEventListener("click", guard(async () => {
      const name = nameIn.value.trim();
      if (!name) { err.textContent = "name required"; return; }
      const body = kbCreateBody(name, descIn.value, tierSel.value, alphaIn.value);
      try {
        await api("/api/knowledge-bases", { method: "POST", body: JSON.stringify(body) });
      } catch (e) {
        err.textContent = String(e.message || e);
        return;
      }
      closeModal();
      location.hash = `#/kb/${encodeURIComponent(name)}`;
    }));
    openModal(h("div", { class: "col", id: "kb-create" },
      h("div", { class: "row" },
        h("h2", {}, t("kb.create")), h("div", { class: "spacer" }),
        h("button", { class: "ghost", onclick: closeModal }, "✕")),
      nameIn, descIn,
      h("div", { class: "row" },
        h("label", { class: "dim" }, `${t("kb.tier")} `, tierSel),
        h("label", { class: "dim" }, "hybrid α ", alphaIn)),
      err,
      h("div", { class: "row" }, h("div", { class: "spacer" }), okBtn)));
    nameIn.focus();
  }

  const createBtn = h("button", { class: "primary" }, `+ ${t("kb.create")}`);
  createBtn.addEventListener("click", openCreateModal);
  const searchIn = h("input", { placeholder: t("kb.search"), style: "flex:1" });
  const grid = h("div", { class: "grid" });

  function renderCards() {
    const kbs = filterKbs(data.knowledge_bases, searchIn.value);
    grid.innerHTML = "";
    for (const kb of kbs) {
      const m = kbCardModel(kb, t("kb.chunks"));
      const del = h("button", { class: "danger ghost" }, "✕");
      del.addEventListener("click", guard(async (ev) => {
        ev.stopPropagation();
        if (!confirm(`delete knowledge base ${kb.name}?`)) return;
        await api(`/api/knowledge-bases/${kb.name}`, { method: "DELETE" });
        location.reload();
      }));
      const card = h("div", { class: "card clickable" },
        h("div", { class: "row" }, h("h2", {}, m.name),
          ...m.badges.map((b) => h("span", { class: b.cls }, b.text)),
          h("div", { class: "spacer" }), del),
        m.description ? h("div", { class: "dim" }, m.description) : null,
        h("div", { class: "dim" }, m.summary));
      card.addEventListener("click", () => { location.hash = `#/kb/${encodeURIComponent(kb.name)}`; });
      grid.appendChild(card);
    }
    if (!kbs.length) grid.appendChild(h("div", { class: "dim" }, t("kb.none")));
  }
  searchIn.addEventListener("input", renderCards);

  view.appendChild(h("div", { class: "col" },
    h("div", { class: "row" }, searchIn, createBtn), grid));
  renderCards();
}

// ------------------------------------------------------------------ detail

async function renderKbDetail(view, name) {
  state.kb = name;
  localStorage.setItem("yrt-kb", name);
  const body = h("div", {});
  const tabs = [
    ["build", t("kb.build"), renderBuildTab],
    ["chunks", t("kb.browse"), renderChunksTab],
    ["qa", t("kb.qa"), renderQaTab],
    ["query", t("kb.query"), renderQueryTab],
    ["tables", t("kb.tables"), renderTablesTab],
    ["index", t("kb.index"), renderIndexTab],
    ["meta", t("kb.meta"), renderMetaTab],
    ["snapshot", t("kb.snapshot"), renderSnapshotTab],
  ];
  const tabBar = h("div", { class: "tabs-inner" });
  let active = sessionStorage.getItem(`yrt-kbtab`) || "build";
  for (const [id, label, render] of tabs) {
    const b = h("button", { class: id === active ? "active" : "" }, label);
    b.addEventListener("click", guard(async () => {
      active = id;
      sessionStorage.setItem("yrt-kbtab", id);
      tabBar.querySelectorAll("button").forEach((x) => x.classList.remove("active"));
      b.classList.add("active");
      body.innerHTML = "";
      await render(body, name);
    }));
    tabBar.appendChild(b);
  }
  view.appendChild(h("div", {},
    h("div", { class: "row" },
      h("a", { href: "#/kb", class: "dim" }, "← knowledge bases"),
      h("h2", { style: "margin:0 0 0 8px" }, name)),
    tabBar, body));
  const entry = tabs.find(([id]) => id === active) || tabs[0];
  await entry[2](body, name);
}

// ------------------------------------------------------------------ build

async function renderBuildTab(root, name) {
  const files = await api("/api/files");
  // selected source files, shown in a summary panel and picked via a
  // searchable paginated modal (ref knowledge-base-detail.js file modal:
  // renderFileModalPagination/confirmFileSelection/updateSelectedFilesHeader)
  const selectedFiles = new Set();
  const selectedBox = h("div", { class: "col" });
  const selectedHead = h("span", { class: "dim" });
  const pickBtn = h("button", {}, t("build.pickFiles"));

  function renderSelected() {
    selectedBox.innerHTML = "";
    selectedHead.textContent = `${selectedFiles.size} selected`;
    const meta = new Map(files.files.map((f) => [f.name, f]));
    for (const n of [...selectedFiles].sort()) {
      const rm = h("button", { class: "ghost" }, "✕");
      rm.addEventListener("click", () => { selectedFiles.delete(n); renderSelected(); });
      selectedBox.appendChild(h("div", { class: "row", style: "gap:6px" },
        rm, n, h("span", { class: "dim" }, fmtBytes((meta.get(n) || {}).size || 0))));
    }
    if (!selectedFiles.size) {
      selectedBox.appendChild(h("div", { class: "dim" }, "(no source files selected)"));
    }
  }

  function openFilePicker() {
    const PICK_PAGE = 10;
    let page = 0;
    const pending = new Set(selectedFiles);
    const search = h("input", { placeholder: t("files.search"), style: "flex:1" });
    const listBox = h("div", { class: "col" });
    const pager = h("span", { class: "dim" });
    const prevB = h("button", {}, "‹");
    const nextB = h("button", {}, "›");
    const allOnPage = h("input", { type: "checkbox", title: "select page" });
    const count = h("span", { class: "dim" });
    const okBtn = h("button", { class: "primary" }, t("build.confirmFiles"));

    function renderList() {
      // page/filter/selection model from transforms.filePickerPage
      const pg = filePickerPage(files.files, search.value, page, PICK_PAGE, [...pending]);
      page = pg.page;
      pager.textContent = pg.pager;
      count.textContent = `${pending.size} selected`;
      listBox.innerHTML = "";
      allOnPage.checked = pg.allChecked;
      for (const f of pg.rows) {
        const c = h("input", { type: "checkbox" });
        c.checked = f.checked;
        c.addEventListener("change", () => {
          if (c.checked) pending.add(f.name); else pending.delete(f.name);
          count.textContent = `${pending.size} selected`;
          allOnPage.checked = pg.rows.every((x) => pending.has(x.name));
        });
        listBox.appendChild(h("label", { class: "row", style: "gap:6px" },
          c, f.name, h("span", { class: "dim" }, f.size)));
      }
      if (!pg.rows.length) listBox.appendChild(h("div", { class: "dim" }, "(no matches)"));
    }
    search.addEventListener("input", () => { page = 0; renderList(); });
    prevB.addEventListener("click", () => { page = Math.max(0, page - 1); renderList(); });
    nextB.addEventListener("click", () => { page += 1; renderList(); });
    allOnPage.addEventListener("change", () => {
      const pg = filePickerPage(files.files, search.value, page, PICK_PAGE, [...pending]);
      for (const f of pg.rows) {
        if (allOnPage.checked) pending.add(f.name); else pending.delete(f.name);
      }
      renderList();
    });
    okBtn.addEventListener("click", () => {
      selectedFiles.clear();
      for (const n of pending) selectedFiles.add(n);
      renderSelected();
      closeModal();
    });
    openModal(h("div", { class: "col", id: "file-picker" },
      h("div", { class: "row" },
        h("h2", {}, t("build.pickFiles")), h("div", { class: "spacer" }),
        h("button", { class: "ghost", onclick: closeModal }, "✕")),
      h("div", { class: "row" }, search, h("label", { class: "dim row" }, allOnPage, " page"), prevB, pager, nextB),
      listBox,
      h("div", { class: "row" }, count, h("div", { class: "spacer" }), okBtn)));
    renderList();
  }
  pickBtn.addEventListener("click", openFilePicker);

  const inlineId = h("input", { placeholder: "doc id" });
  const inlineText = h("textarea", { placeholder: t("build.inline"), rows: "4", style: "width:100%" });
  const rebuild = h("input", { type: "checkbox" });
  const runBtn = h("button", { class: "primary" }, t("build.run"));
  const report = h("div", {});
  const logsBox = h("div", {});

  function drilldownBox(l) {
    // per-source stage states + error drill-down; the event-stream reduce
    // lives in transforms.buildDrilldown (pytest-golden-tested)
    const d = buildDrilldown(l);
    const box = h("div", {});
    box.appendChild(h("h3", {}, `${t("build.logs")} — ${new Date(l.time * 1000).toLocaleString()}`));
    if (d.rows.length) {
      box.appendChild(h("table", {},
        h("tr", {}, h("th", {}, "source"), h("th", {}, "stage"), h("th", {}, "progress")),
        d.rows.map((r) => h("tr", {},
          h("td", {}, r.source),
          h("td", {}, h("span", { class: `badge ${r.cls}` }, r.status)),
          h("td", { class: "dim" }, r.progress)))));
    } else {
      box.appendChild(h("div", { class: "dim" }, "(no per-source events recorded)"));
    }
    if (d.errors.length) {
      box.appendChild(h("h3", {}, `errors (${d.errors.length})`));
      box.appendChild(h("pre", { class: "prewrap" }, d.errors.join("\n")));
    }
    if (d.summary) box.appendChild(h("div", { class: "dim" }, d.summary));
    return box;
  }

  async function refreshLogs() {
    const logs = await api(`/api/knowledge-bases/${name}/build-logs`);
    logsBox.innerHTML = "";
    if (!logs.logs.length) { logsBox.appendChild(h("div", { class: "dim" }, "(no builds yet)")); return; }
    const raw = logs.logs.slice(-10).reverse();
    const rows = buildLogRows(logs.logs).map((r, i) =>
      h("tr", { class: "clickable", onclick: () => openModal(drilldownBox(raw[i])) },
        h("td", {}, new Date(r.time * 1000).toLocaleTimeString()),
        h("td", {}, h("span", { class: `badge ${r.cls}` }, r.status)),
        h("td", {}, r.result),
        h("td", { class: "dim" }, r.errors)));
    logsBox.appendChild(h("table", {},
      h("tr", {}, h("th", {}, "time"), h("th", {}, "status"), h("th", {}, "result"), h("th", {}, "errors")),
      rows));
  }

  runBtn.addEventListener("click", guard(async () => {
    const selected = [...selectedFiles];
    const docs = [];
    if (inlineText.value.trim()) {
      docs.push({ id: inlineId.value.trim() || `inline-${Date.now()}`, content: inlineText.value });
    }
    if (!selected.length && !docs.length) { toast("select files or add an inline document", "err"); return; }
    runBtn.disabled = true;
    report.innerHTML = "";
    report.appendChild(h("div", { class: "dim" }, "building…"));
    const poll = setInterval(() => refreshLogs().catch(() => {}), 1000);
    try {
      const r = await api(`/api/knowledge-bases/${name}/build`, {
        method: "POST",
        body: JSON.stringify({ files: selected, documents: docs, rebuild: rebuild.checked }),
      });
      report.innerHTML = "";
      report.appendChild(h("div", {},
        h("span", { class: `badge ${r.status.status === "completed" ? "ok" : "err"}` }, r.status.status),
        ` ${buildReportSummary(r)}`,
        r.status.errors.length ? h("pre", {}, r.status.errors.join("\n")) : null));
      toast(`build ${r.status.status}`, r.status.errors.length ? "err" : "ok");
    } finally {
      clearInterval(poll);
      runBtn.disabled = false;
      refreshLogs();
    }
  }));

  // source configuration: declared source list with removed-source
  // cleanup on save + config-driven build (ref kb-detail configuration)
  const cfgInfo = h("span", { class: "dim" });
  const saveCfgBtn = h("button", {}, t("build.saveConfig"));
  const fromCfgBtn = h("button", {}, t("build.fromConfig"));
  saveCfgBtn.addEventListener("click", guard(async () => {
    const selected = [...selectedFiles];
    const r = await api(`/api/knowledge-bases/${name}/config`, {
      method: "PUT", body: JSON.stringify({ sources: { files: selected } }),
    });
    const cleaned = r.cleaned.map((c) => c.source);
    cfgInfo.textContent = `config: ${selected.length} files`
      + (cleaned.length ? ` · cleaned removed: ${cleaned.join(", ")}` : "");
    toast("source config saved", "ok");
  }));
  fromCfgBtn.addEventListener("click", guard(async () => {
    const r = await api(`/api/knowledge-bases/${name}/build`, {
      method: "POST", body: JSON.stringify({ from_config: true, rebuild: rebuild.checked }),
    });
    toast(`build ${r.status.status}: ${r.status.total_chunks} chunks`, "ok");
    await refreshLogs();
  }));
  api(`/api/knowledge-bases/${name}/config`).then((c) => {
    const declared = c.sources.files || [];
    if (declared.length) cfgInfo.textContent = `config: ${declared.length} files declared`;
    // pre-select the declared sources so build/save start from the config
    for (const n of declared) selectedFiles.add(n);
    renderSelected();
  }).catch(() => {});

  // QA file validation + attach (ref selectedQAFiles + validate_qa_file)
  const qaFileSel = h("select", {});
  qaFileSel.appendChild(h("option", { value: "" }, "(QA file…)"));
  for (const f of files.files.filter((x) => /\.(csv|xlsx|xls)$/i.test(x.name))) {
    qaFileSel.appendChild(h("option", {}, f.name));
  }
  const qaValidateBtn = h("button", {}, t("build.qaValidate"));
  const qaBuildBtn = h("button", {}, t("build.qaBuild"));
  const qaOut = h("div", {});
  qaValidateBtn.addEventListener("click", guard(async () => {
    if (!qaFileSel.value) return;
    qaOut.innerHTML = "";
    const r = await api("/api/qa-files/validate", {
      method: "POST", body: JSON.stringify({ file: qaFileSel.value }),
    });
    if (r.valid) {
      qaOut.appendChild(h("div", {},
        h("span", { class: "badge ok" }, "valid"),
        ` ${r.row_count} pairs · columns: ${r.columns.join(", ")}`));
    } else {
      qaOut.appendChild(h("div", { class: "pwin-error" }, r.errors.join("; ")));
    }
  }));
  qaBuildBtn.addEventListener("click", guard(async () => {
    if (!qaFileSel.value) return;
    const r = await api(`/api/knowledge-bases/${name}/build`, {
      method: "POST", body: JSON.stringify({ qa_files: [qaFileSel.value] }),
    });
    toast(`QA build ${r.status.status}: ${r.status.total_chunks} pairs indexed`,
      r.status.errors.length ? "err" : "ok");
    await refreshLogs();
  }));

  // DB connection tester (ref kb_config_routes DB connection test)
  const dbUrl = h("input", { placeholder: "sqlite:///path.db or uploaded .db name", style: "flex:1" });
  const dbBtn = h("button", {}, t("build.dbTest"));
  const dbOut = h("div", {});
  dbBtn.addEventListener("click", guard(async () => {
    const v = dbUrl.value.trim();
    if (!v) return;
    const body = v.includes("://") ? { url: v } : { file: v };
    dbOut.innerHTML = "";
    try {
      const r = await api("/api/db/test", { method: "POST", body: JSON.stringify(body) });
      dbOut.appendChild(h("div", {},
        h("span", { class: "badge ok" }, r.dialect),
        ` ${r.tables.length} tables: ${r.tables.map((x) => x.table).join(", ")}`));
    } catch (e) {
      dbOut.appendChild(h("div", { class: "pwin-error" }, String(e.message || e)));
    }
  }));

  root.appendChild(h("div", { class: "col" },
    h("div", { class: "card" },
      h("div", { class: "row" }, h("h3", {}, t("build.files")), pickBtn, selectedHead),
      files.files.length ? selectedBox
        : h("div", { class: "dim" }, "(upload files in the Files tab first)"),
      h("h3", {}, t("build.inline")),
      h("div", { class: "row" }, inlineId),
      inlineText,
      h("div", { class: "row", style: "margin-top:8px" },
        h("label", { class: "dim" }, rebuild, ` ${t("build.rebuild")}`),
        h("div", { class: "spacer" }), runBtn),
      report),
    h("div", { class: "card col" },
      h("h3", {}, t("build.sources")),
      h("div", { class: "row" }, saveCfgBtn, fromCfgBtn, cfgInfo),
      h("div", { class: "row" }, qaFileSel, qaValidateBtn, qaBuildBtn), qaOut,
      h("div", { class: "row" }, dbUrl, dbBtn), dbOut),
    h("div", { class: "card" }, h("h3", {}, t("build.logs")), logsBox)));
  await refreshLogs();
}

// ------------------------------------------------------------------ chunks

async function renderChunksTab(root, name) {
  const PAGE = 25;
  let offset = 0;
  const q = h("input", { placeholder: t("chunks.search"), style: "flex:1" });
  const stats = h("span", { class: "dim" });
  const table = h("div", {});
  const prev = h("button", {}, "‹");
  const next = h("button", {}, "›");

  async function load() {
    const data = await api(`/api/knowledge-bases/${name}/chunks?limit=${PAGE}&offset=${offset}&q=${encodeURIComponent(q.value.trim())}`);
    stats.textContent = chunkStatsLine(data, offset);
    table.innerHTML = "";
    const rows = chunkRows(data.chunks).map((m, i) => {
      const c = data.chunks[i];
      const tr = h("tr", { class: "clickable" },
        h("td", { class: "dim" }, m.key),
        h("td", {}, m.excerpt),
        h("td", { class: "dim" }, m.index));
      tr.addEventListener("click", () => {
        openModal(h("div", {},
          h("h2", {}, `${c.document_id} #${c.chunk_index}`),
          h("pre", {}, c.content),
          h("h3", {}, "metadata"),
          h("pre", {}, JSON.stringify(c.metadata, null, 2)),
          h("button", { onclick: closeModal }, "close")));
      });
      return tr;
    });
    table.appendChild(h("table", {},
      h("tr", {}, h("th", {}, "chunk"), h("th", {}, "content"), h("th", {}, "index")),
      rows));
  }

  prev.addEventListener("click", guard(async () => { offset = Math.max(0, offset - PAGE); await load(); }));
  next.addEventListener("click", guard(async () => { offset += PAGE; await load(); }));
  q.addEventListener("keydown", guard(async (e) => { if (e.key === "Enter") { offset = 0; await load(); } }));

  root.appendChild(h("div", { class: "card col" },
    h("div", { class: "row" }, q, prev, next, stats), table));
  await load();
}

// ------------------------------------------------------------------ qa

async function renderQaTab(root, name) {
  const qIn = h("input", { placeholder: t("qa.question"), style: "flex:1" });
  const aIn = h("input", { placeholder: t("qa.answer"), style: "flex:1" });
  const addBtn = h("button", { class: "primary" }, t("qa.add"));
  const askIn = h("input", { placeholder: t("qa.question"), style: "flex:1" });
  const thIn = h("input", { type: "number", value: "0.6", step: "0.05", min: "0", max: "1", style: "width:80px", title: t("qa.threshold") });
  const askBtn = h("button", {}, t("qa.ask"));
  const askOut = h("div", {});
  const listBox = h("div", {});

  async function load() {
    const data = await api(`/api/knowledge-bases/${name}/qa-pairs?limit=100`);
    listBox.innerHTML = "";
    if (!data.qa_pairs.length) { listBox.appendChild(h("div", { class: "dim" }, "(no QA pairs)")); return; }
    const rows = data.qa_pairs.map((p) => {
      const del = h("button", { class: "danger ghost" }, "✕");
      del.addEventListener("click", guard(async () => {
        await api(`/api/knowledge-bases/${name}/qa-pairs?id=${encodeURIComponent(p.id)}`, { method: "DELETE" });
        await load();
      }));
      // execute: agent selection + run + persisted result (qa/execute)
      const exec = h("button", { class: "ghost", title: t("qa.execute") }, "▶");
      exec.addEventListener("click", guard(async () => {
        exec.disabled = true; exec.textContent = "…";
        try {
          const r = await api(`/api/knowledge-bases/${name}/qa/execute`, {
            method: "POST", body: JSON.stringify({ id: p.id }),
          });
          const results = (r.execution_results || []).map((x) =>
            h("div", {},
              h("span", { class: x.success ? "badge ok" : "badge err" }, x.agent),
              h("pre", {}, x.success ? (x.answer || "(empty)") : (x.error || "failed"))));
          openModal(h("div", {},
            h("h2", {}, t("qa.executed")),
            h("div", { class: "dim" }, `agents: ${(r.selected_agents || []).join(", ")} · ${r.final_status}`),
            ...results,
            h("button", { onclick: closeModal }, "close")));
        } finally {
          exec.disabled = false; exec.textContent = "▶";
          await load();
        }
      }));
      const tr = h("tr", { class: "clickable" },
        h("td", {}, p.question), h("td", { class: "dim" }, (p.answer || "").slice(0, 100)),
        h("td", {}, h("span", { class: `badge ${qaStatusCls(p.learning_status)}` }, p.learning_status || "pending")),
        h("td", { class: "dim" }, p.source_id), h("td", {}, exec, del));
      tr.addEventListener("click", (ev) => {
        if (ev.target === del || ev.target === exec) return;
        // qa-detail page: deep-linkable pair + history + editing
        location.hash = `#/kb/${encodeURIComponent(name)}/qa/${encodeURIComponent(p.id)}`;
      });
      return tr;
    });
    listBox.appendChild(h("table", {},
      h("tr", {}, h("th", {}, "question"), h("th", {}, "answer"), h("th", {}, "status"),
        h("th", {}, "source"), h("th", {}, "")),
      rows));
  }

  addBtn.addEventListener("click", guard(async () => {
    if (!qIn.value.trim()) return;
    await api(`/api/knowledge-bases/${name}/qa-pairs`, {
      method: "POST",
      body: JSON.stringify({ pairs: [{ question: qIn.value.trim(), answer: aIn.value.trim() }] }),
    });
    qIn.value = ""; aIn.value = "";
    await load();
  }));

  askBtn.addEventListener("click", guard(async () => {
    const r = await api(`/api/knowledge-bases/${name}/qa`, {
      method: "POST",
      body: JSON.stringify({ question: askIn.value.trim(), threshold: parseFloat(thIn.value) }),
    });
    askOut.innerHTML = "";
    const res = qaAskResult(r);
    if (res.matched) {
      askOut.appendChild(h("div", {},
        h("span", { class: "badge ok" }, res.badge), h("pre", {}, res.answer)));
    } else {
      askOut.appendChild(h("div", { class: "dim" }, res.text));
    }
  }));

  root.appendChild(h("div", { class: "col" },
    h("div", { class: "card col" },
      h("h3", {}, "add"), h("div", { class: "row" }, qIn, aIn, addBtn),
      h("h3", {}, "ask"), h("div", { class: "row" }, askIn, thIn, askBtn), askOut),
    h("div", { class: "card" }, listBox)));
  await load();
}

// ------------------------------------------------------------------ qa detail
// Dedicated page per QA pair (deep-linkable: #/kb/<name>/qa/<id>) with
// markdown rendering, inline editing, execution history, and re-execution.
// Counterpart of rag_webui's qa-detail.js page flow.

async function renderQaDetail(view, name, id) {
  const data = await api(`/api/knowledge-bases/${name}/qa-pairs?limit=1000`);
  const p = data.qa_pairs.find((x) => x.id === id);
  const back = h("a", { href: `#/kb/${encodeURIComponent(name)}`, class: "dim" }, `← ${name}`);
  if (!p) {
    view.appendChild(h("div", {}, back, h("div", { class: "card" }, `QA pair ${id} not found`)));
    return;
  }

  const qEdit = h("textarea", { rows: "2", style: "width:100%" }); qEdit.value = p.question;
  const aEdit = h("textarea", { rows: "5", style: "width:100%" }); aEdit.value = p.answer || "";
  const saveBtn = h("button", { class: "primary" }, t("qa.edit"));
  saveBtn.addEventListener("click", guard(async () => {
    // edit = delete-then-reinsert (the pair's question is its vector,
    // so an edited question must re-embed — same semantics as chunks)
    const newQ = qEdit.value.trim();
    await api(`/api/knowledge-bases/${name}/qa-pairs`, {
      method: "POST",
      body: JSON.stringify({ pairs: [{ question: newQ, answer: aEdit.value.trim() }] }),
    });
    await api(`/api/knowledge-bases/${name}/qa-pairs?id=${encodeURIComponent(p.id)}`, { method: "DELETE" });
    // find the re-inserted pair to deep-link it (POST returns a count)
    const fresh = await api(`/api/knowledge-bases/${name}/qa-pairs?limit=1000`);
    const np = fresh.qa_pairs.find((x) => x.question === newQ);
    toast("QA pair updated", "ok");
    location.hash = np
      ? `#/kb/${encodeURIComponent(name)}/qa/${encodeURIComponent(np.id)}`
      : `#/kb/${encodeURIComponent(name)}`;
    if (np && location.hash === `#/kb/${encodeURIComponent(name)}/qa/${encodeURIComponent(np.id)}`) {
      // same-route hash may not retrigger; force re-render
      view.innerHTML = "";
      await renderQaDetail(view, name, np.id);
    }
  }));

  const execBtn = h("button", {}, `▶ ${t("qa.execute")}`);
  const execOut = h("div", {});
  execBtn.addEventListener("click", guard(async () => {
    execBtn.disabled = true; execBtn.textContent = "…";
    try {
      const r = await api(`/api/knowledge-bases/${name}/qa/execute`, {
        method: "POST", body: JSON.stringify({ id: p.id }),
      });
      execOut.innerHTML = "";
      execOut.appendChild(h("div", { class: "dim" },
        `agents: ${(r.selected_agents || []).join(", ")} · ${r.final_status}`));
      for (const x of (r.execution_results || [])) {
        execOut.appendChild(h("div", {},
          h("span", { class: x.success ? "badge ok" : "badge err" }, x.agent),
          x.success ? renderMarkdown(x.answer || "(empty)") : h("pre", {}, x.error || "failed"),
          x.success && (p.answer || "").trim()
            ? h("details", {}, h("summary", { class: "dim" }, "diff vs expected"),
                renderDiff(p.answer, x.answer))
            : null));
      }
    } finally {
      execBtn.disabled = false; execBtn.textContent = `▶ ${t("qa.execute")}`;
    }
  }));

  let history = null;
  if (p.executed_results) {
    history = h("div", { class: "card col" },
      h("h3", {}, t("qa.history")),
      h("div", { class: "dim" },
        `${p.executed_agents || "?"} · ${p.learning_status || ""} · ${p.executed_at || ""}` +
        (p.memory_status ? ` · memory: ${p.memory_status}` : "")),
      ...qaHistoryRows(p).map((x) => h("div", {},
        h("span", { class: x.cls }, x.agent),
        x.success ? renderMarkdown(x.body) : h("pre", {}, x.body),
        x.success && (p.answer || "").trim()
          ? h("details", {}, h("summary", { class: "dim" }, "diff vs expected"),
              renderDiff(p.answer, x.body))
          : null)));
  }

  const statusCls = qaStatusCls(p.learning_status);
  view.appendChild(h("div", { class: "col" },
    h("div", { class: "row" }, back,
      h("h2", { style: "margin:0 0 0 8px" }, t("qa.detail")),
      h("span", { class: `badge ${statusCls}` }, p.learning_status || "pending")),
    h("div", { class: "card col" },
      h("h3", {}, t("qa.question")), qEdit,
      h("h3", {}, t("qa.answer")), aEdit,
      h("div", { class: "row" }, saveBtn, execBtn),
      h("div", { class: "dim" }, qaDetailMetaLine(p)),
      execOut),
    history,
    h("div", { class: "card col" },
      h("h3", {}, "stored answer (rendered)"),
      renderMarkdown(p.answer || "(empty)"))));
}

// ------------------------------------------------------------------ query tester

async function renderQueryTab(root, name) {
  const qIn = h("input", { placeholder: "retrieval query…", style: "flex:1" });
  const kIn = h("input", { type: "number", value: "5", min: "1", max: "50", style: "width:70px" });
  // retrieval mode: dense | hybrid (corpus BM25 fusion) | lexical (BM25 only)
  const modeSel = h("select", { title: "retrieval mode" },
    h("option", { value: "dense" }, "dense"),
    h("option", { value: "hybrid" }, "hybrid"),
    h("option", { value: "lexical" }, "lexical"));
  // dense weight for hybrid fusion (0 = lexical-only ranking, 1 = dense)
  const alphaIn = h("input", {
    type: "number", value: "0.5", min: "0", max: "1", step: "0.1",
    style: "width:64px; display:none", title: "hybrid alpha (dense weight)",
  });
  modeSel.addEventListener("change", () => {
    alphaIn.style.display = modeSel.value === "hybrid" ? "" : "none";
  });
  const btn = h("button", { class: "primary" }, t("kb.query"));
  const out = h("div", {});
  btn.addEventListener("click", guard(async () => {
    const body = queryRequestBody(qIn.value, kIn.value, modeSel.value, alphaIn.value);
    if (body.hybrid_alpha !== undefined) alphaIn.value = String(body.hybrid_alpha);
    const r = await api(`/api/knowledge-bases/${name}/query`, {
      method: "POST", body: JSON.stringify(body),
    });
    out.innerHTML = "";
    out.appendChild(h("div", { class: "dim" }, `${r.total_results} results in ${r.retrieval_time_ms.toFixed(1)} ms`));
    for (const res of r.results) {
      out.appendChild(h("div", { class: "card", style: "margin-top:8px" },
        h("div", { class: "row" },
          h("span", { class: "badge" }, `#${res.rank}`),
          h("span", { class: "badge ok" }, res.score.toFixed(4)),
          h("span", { class: "dim" }, `${res.document_id}#${res.chunk_index}`)),
        h("div", { style: "margin-top:6px" }, res.content.slice(0, 400))));
    }
  }));
  root.appendChild(h("div", { class: "card col" }, h("div", { class: "row" }, qIn, kIn, modeSel, alphaIn, btn), out));
}

// ------------------------------------------------------------------ tables
// Structured-table registry + read-only SQL console over the KB's table
// store (counterpart of rag_webui kb-detail's DB tables management).

function resultTable(r) {
  const m = sqlResultModel(r);
  if (!m) return h("div", { class: "dim" }, "(no rows)");
  return h("table", {},
    h("tr", {}, ...m.columns.map((c) => h("th", {}, c))),
    ...m.rows.map((row) => h("tr", {}, ...row.map((v) => h("td", {}, v)))));
}

async function renderTablesTab(root, name) {
  const listBox = h("div", {});
  const sqlIn = h("textarea", { rows: "3", style: "width:100%", placeholder: "SELECT … (read-only)" });
  const sqlBtn = h("button", { class: "primary" }, t("tables.sql"));
  const sqlOut = h("div", {});

  async function load() {
    const data = await api(`/api/knowledge-bases/${name}/tables`);
    listBox.innerHTML = "";
    if (!data.tables.length) {
      listBox.appendChild(h("div", { class: "dim" }, t("tables.none")));
      return;
    }
    const rows = tableRows(data.tables).map((m, i) => {
      const tb = data.tables[i];
      const del = h("button", { class: "danger ghost" }, "✕");
      del.addEventListener("click", guard(async (ev) => {
        ev.stopPropagation();
        if (!confirm(`drop table ${tb.table_name}?`)) return;
        await api(`/api/knowledge-bases/${name}/tables?table=${encodeURIComponent(tb.table_name)}`, { method: "DELETE" });
        await load();
      }));
      const tr = h("tr", { class: "clickable" },
        h("td", {}, m.name),
        h("td", { class: "dim" }, m.source),
        h("td", {}, m.size),
        h("td", { class: "dim" }, m.columns),
        h("td", {}, del));
      tr.addEventListener("click", guard(async (ev) => {
        if (ev.target === del) return;
        const r = await api(`/api/knowledge-bases/${name}/tables?table=${encodeURIComponent(tb.table_name)}&limit=20`);
        openModal(h("div", {},
          h("h2", {}, tb.table_name),
          h("div", { class: "dim" }, `${tb.n_rows} rows · source ${tb.source}`),
          resultTable(r),
          h("button", { onclick: closeModal }, "close")));
      }));
      return tr;
    });
    listBox.appendChild(h("table", {},
      h("tr", {}, h("th", {}, "table"), h("th", {}, "source"), h("th", {}, "size"),
        h("th", {}, "columns"), h("th", {}, "")),
      rows));
  }

  sqlBtn.addEventListener("click", guard(async () => {
    const sql = sqlIn.value.trim();
    if (!sql) return;
    sqlOut.innerHTML = "";
    try {
      const r = await api(`/api/knowledge-bases/${name}/tables`, {
        method: "POST", body: JSON.stringify({ sql }),
      });
      sqlOut.appendChild(h("div", { class: "dim" }, `${r.row_count} rows`));
      sqlOut.appendChild(resultTable(r));
    } catch (e) {
      sqlOut.appendChild(h("div", { class: "pwin-error" }, String(e.message || e)));
    }
  }));

  root.appendChild(h("div", { class: "col" },
    h("div", { class: "card" }, listBox),
    h("div", { class: "card col" }, h("h3", {}, "SQL"), sqlIn,
      h("div", { class: "row" }, h("div", { class: "spacer" }), sqlBtn), sqlOut)));
  await load();
}

// ------------------------------------------------------------------ index

async function renderIndexTab(root, name) {
  const stateBox = h("pre", {});
  const nLists = h("input", { type: "number", placeholder: "n_lists (auto)", style: "width:130px" });
  const buildBtn = h("button", { class: "primary" }, "Build IVF");
  const dropBtn = h("button", {}, "Drop IVF");
  const compactBtn = h("button", {}, "Compact");

  async function load() {
    const s = await api(`/api/knowledge-bases/${name}/index`);
    stateBox.textContent = JSON.stringify(s, null, 2);
  }
  async function act(action, extra = {}) {
    const r = await api(`/api/knowledge-bases/${name}/index`, {
      method: "POST", body: JSON.stringify({ action, ...extra }),
    });
    toast(JSON.stringify(r), "ok");
    await load();
  }
  buildBtn.addEventListener("click", guard(() =>
    act("build_ivf", nLists.value ? { n_lists: parseInt(nLists.value) } : {})));
  dropBtn.addEventListener("click", guard(() => act("drop_ivf")));
  compactBtn.addEventListener("click", guard(() => act("compact")));

  root.appendChild(h("div", { class: "card col" },
    h("div", { class: "row" }, nLists, buildBtn, dropBtn, compactBtn), stateBox));
  await load();
}

// ------------------------------------------------------------------ metadata

async function renderMetaTab(root, name) {
  const exportBtn = h("a", { href: `/api/knowledge-bases/${name}/metadata`, download: `${name}-metadata.csv` },
    h("button", {}, "Export CSV"));
  const importBox = h("textarea", { rows: "6", style: "width:100%", placeholder: '{"updates": [{"id": "…", "metadata": {…}}]}' });
  const importBtn = h("button", { class: "primary" }, "Import JSON");
  const out = h("div", { class: "dim" });
  importBtn.addEventListener("click", guard(async () => {
    const r = await api(`/api/knowledge-bases/${name}/metadata`, { method: "PUT", body: importBox.value });
    out.textContent = JSON.stringify(r);
    toast("metadata updated", "ok");
  }));
  root.appendChild(h("div", { class: "card col" },
    h("div", { class: "row" }, exportBtn, importBtn), importBox, out));
}

// ------------------------------------------------------------------ snapshot

async function renderSnapshotTab(root, name) {
  const out = h("pre", {});
  const saveBtn = h("button", { class: "primary" }, "Save snapshot");
  const restoreBtn = h("button", {}, "Restore latest");
  async function act(action) {
    const r = await api(`/api/knowledge-bases/${name}/snapshot`, {
      method: "POST", body: JSON.stringify({ action }),
    });
    out.textContent = JSON.stringify(r, null, 2);
    toast(`snapshot ${action} ok`, "ok");
  }
  saveBtn.addEventListener("click", guard(() => act("save")));
  restoreBtn.addEventListener("click", guard(() => act("restore")));
  root.appendChild(h("div", { class: "card col" },
    h("div", { class: "row" }, saveBtn, restoreBtn),
    h("div", { class: "dim" }, "snapshots persist the device index (int8-native) + chunk payloads + manifest"),
    out));
}
