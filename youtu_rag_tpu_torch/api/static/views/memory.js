// Memory browser: stat tiles per memory type, type-filter chips,
// semantic search, newest-first table with importance/skill stats,
// manual add + single/batch delete. Management surface over the memory
// plane (working/episodic/semantic/procedural — ref memory_toolkit.py
// 316-446); the reference only reaches memories through agent retrieval
// and an offline export script, so this view has no rag_webui
// counterpart — it fills the gap humans hit operating the memory plane.

import { api, guard, h, t, toast } from "../app.js";
import { memoryRow, memoryTiles, pagerText } from "./transforms.js";

const TYPES = ["working", "episodic", "semantic", "procedural"];
const PAGE_SIZE = 25;

function typeBadge(type) {
  return h("span", { class: `badge mem-${type}` }, type);
}

export async function renderMemory(view) {
  const tiles = h("div", { class: "grid" });
  const tableBox = h("div", {});
  const searchIn = h("input", { id: "mem-search", placeholder: t("mem.search"), style: "flex:1" });
  const pager = h("span", { class: "dim" });
  const prevBtn = h("button", {}, "‹");
  const nextBtn = h("button", {}, "›");
  const batchDel = h("button", { class: "danger ghost" }, t("mem.batchDelete"));
  const chipRow = h("div", { class: "row", id: "mem-chips" });
  const addContent = h("textarea", { id: "mem-add-content", placeholder: t("mem.add.ph") });
  const addType = h("select", {}, ...TYPES.map((x) => h("option", {}, x)));
  addType.value = "semantic";
  const addImportance = h("input", { type: "number", min: "0", max: "1", step: "0.1", value: "0.5", title: "importance" });
  const addBtn = h("button", { class: "primary" }, t("mem.add"));

  let page = 0;
  const activeTypes = new Set(TYPES);
  const selected = new Set();

  for (const type of TYPES) {
    const chip = h("button", { class: "chip active" }, type);
    chip.addEventListener("click", guard(async () => {
      if (activeTypes.has(type)) activeTypes.delete(type);
      else activeTypes.add(type);
      chip.classList.toggle("active", activeTypes.has(type));
      page = 0;
      await load();
    }));
    chipRow.appendChild(chip);
  }

  async function load() {
    const q = searchIn.value.trim();
    const types = [...activeTypes].join(",");
    const params = new URLSearchParams({ limit: String(PAGE_SIZE), offset: String(page * PAGE_SIZE) });
    if (q) params.set("q", q);
    if (types && activeTypes.size < TYPES.length) params.set("types", types);
    const data = await api(`/api/memory/items?${params}`);

    tiles.innerHTML = "";
    for (const tile of memoryTiles(data.stats, TYPES)) {
      tiles.appendChild(h("div", { class: "tile" },
        h("div", { class: "tile-value" }, String(tile.value)),
        h("div", { class: "tile-label" },
          tile.label === "total" ? t("mem.total") : tile.label)));
    }

    pager.textContent = pagerText(page, data.total, PAGE_SIZE);
    tableBox.innerHTML = "";
    if (!data.items.length) {
      tableBox.appendChild(h("div", { class: "dim" }, t("mem.none")));
      return;
    }
    const rows = data.items.map((m) => {
      const check = h("input", { type: "checkbox" });
      check.checked = selected.has(m.id);
      check.addEventListener("change", () => {
        if (check.checked) selected.add(m.id); else selected.delete(m.id);
      });
      const delBtn = h("button", { class: "danger ghost" }, "✕");
      delBtn.addEventListener("click", guard(async () => {
        await api("/api/memory/items", {
          method: "DELETE", body: JSON.stringify({ ids: [m.id] }),
        });
        selected.delete(m.id);
        await load();
      }));
      const row = memoryRow(m);
      return h("tr", {},
        h("td", {}, check),
        h("td", {}, typeBadge(row.type)),
        h("td", { class: "mem-content", title: m.content }, row.content),
        h("td", { class: "dim" }, row.signals),
        h("td", { class: "dim" }, new Date(row.createdAt * 1000).toLocaleString()),
        h("td", {}, delBtn));
    });
    tableBox.appendChild(h("table", {},
      h("tr", {}, h("th"), h("th", {}, "type"), h("th", {}, t("mem.content")),
        h("th", {}, t("mem.signals")), h("th", {}, "created"), h("th")),
      rows));
  }

  batchDel.addEventListener("click", guard(async () => {
    if (!selected.size) { toast("nothing selected", "err"); return; }
    if (!confirm(`delete ${selected.size} memories?`)) return;
    await api("/api/memory/items", {
      method: "DELETE", body: JSON.stringify({ ids: [...selected] }),
    });
    selected.clear();
    toast("deleted", "ok");
    await load();
  }));

  addBtn.addEventListener("click", guard(async () => {
    const content = addContent.value.trim();
    if (!content) { toast(t("mem.add.ph"), "err"); return; }
    await api("/api/memory/items", {
      method: "POST",
      body: JSON.stringify({
        content, memory_type: addType.value,
        importance: parseFloat(addImportance.value) || 0.5,
      }),
    });
    addContent.value = "";
    toast("memory stored", "ok");
    await load();
  }));

  let timer = null;
  searchIn.addEventListener("input", () => {
    clearTimeout(timer);
    timer = setTimeout(guard(async () => { page = 0; await load(); }), 250);
  });
  prevBtn.addEventListener("click", guard(async () => { page = Math.max(0, page - 1); await load(); }));
  nextBtn.addEventListener("click", guard(async () => { page += 1; await load(); }));

  view.appendChild(h("div", { class: "col" },
    tiles,
    h("div", { class: "card col" },
      h("div", { class: "row" }, chipRow, searchIn, prevBtn, pager, nextBtn, batchDel),
      tableBox),
    h("div", { class: "card col" },
      h("h3", {}, t("mem.add.title")),
      addContent,
      h("div", { class: "row" }, addType, addImportance, addBtn))));
  await load();
}
