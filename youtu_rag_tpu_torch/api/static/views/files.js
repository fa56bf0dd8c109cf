// File manager: upload with live stage progress (PENDING → UPLOADING →
// OCR_PROCESSING → METADATA_EXTRACTING → CHUNK_PROCESSING → COMPLETED),
// file table with metadata, OCR viewer/editor with per-page markdown +
// layout overlays. Counterpart of rag_webui's file-manager.js + the
// reference's OCR screens (minio_files.py:1500-1811).

import { api, fmtBytes, guard, h, openModal, closeModal, t, toast } from "../app.js";
import { csvTable, renderMarkdown } from "./utils.js";

const STAGES = ["PENDING", "UPLOADING", "OCR_PROCESSING", "METADATA_EXTRACTING",
  "UPLOADING_TO_MINIO", "CHUNK_PROCESSING", "COMPLETED"];

const PREVIEW_EXTS = [".md", ".markdown", ".txt", ".csv", ".json", ".jsonl", ".py", ".html", ".log"];
const PAGE_SIZE = 25;

// ------------------------------------------------- persisted upload tasks
// ref file-manager.js STORAGE_KEY/saveUploadTask/getStoredUploadTasks

const UPLOAD_TASKS_KEY = "yrt-upload-tasks";

function getStoredUploadTasks() {
  try { return JSON.parse(localStorage.getItem(UPLOAD_TASKS_KEY)) || []; } catch { return []; }
}

function saveUploadTask(taskId, filename) {
  const tasks = getStoredUploadTasks().filter((x) => x.task_id !== taskId);
  tasks.push({ task_id: taskId, filename });
  localStorage.setItem(UPLOAD_TASKS_KEY, JSON.stringify(tasks.slice(-20)));
}

function removeUploadTask(taskId) {
  const tasks = getStoredUploadTasks().filter((x) => x.task_id !== taskId);
  localStorage.setItem(UPLOAD_TASKS_KEY, JSON.stringify(tasks));
}

export async function renderFiles(view) {
  const fileInput = h("input", { type: "file", multiple: "" });
  const upBtn = h("button", {}, t("files.upload"));
  const upProgBtn = h("button", { class: "primary" }, t("files.upload.progress"));
  const progWrap = h("div", { class: "col", style: "min-width:260px" });
  const tableBox = h("div", {});
  const searchIn = h("input", { placeholder: t("files.search"), style: "flex:1" });
  const summary = h("span", { class: "dim" });
  const batchDel = h("button", { class: "danger ghost" }, t("files.batchDelete"));
  const selAll = h("input", { type: "checkbox", title: "select all" });
  const pager = h("span", { class: "dim" });
  const prevBtn = h("button", {}, "‹");
  const nextBtn = h("button", {}, "›");

  // sort + filter + page state (ref file-manager's sorted/filtered views)
  let sortKey = "uploaded_at", sortDir = -1, page = 0;
  const selected = new Set();

  function sortable(label, key) {
    const th = h("th", { class: "clickable" },
      `${label}${sortKey === key ? (sortDir > 0 ? " ▲" : " ▼") : ""}`);
    th.addEventListener("click", guard(async () => {
      if (sortKey === key) sortDir = -sortDir; else { sortKey = key; sortDir = 1; }
      await load();
    }));
    return th;
  }

  async function load() {
    const data = await api("/api/files");
    tableBox.innerHTML = "";
    const q = searchIn.value.trim().toLowerCase();
    let files = data.files.filter((f) => !f.name.startsWith(".meta"));
    const totalBytes = files.reduce((a, f) => a + (f.size || 0), 0);
    summary.textContent = `${files.length} files · ${fmtBytes(totalBytes)}`;
    if (q) files = files.filter((f) => f.name.toLowerCase().includes(q));
    files.sort((a, b) => {
      const va = a[sortKey] ?? "", vb = b[sortKey] ?? "";
      return (va < vb ? -1 : va > vb ? 1 : 0) * sortDir;
    });
    const pages = Math.max(1, Math.ceil(files.length / PAGE_SIZE));
    page = Math.min(page, pages - 1);
    pager.textContent = `${page + 1}/${pages}`;
    const shown = files.slice(page * PAGE_SIZE, (page + 1) * PAGE_SIZE);
    if (!shown.length) {
      tableBox.appendChild(h("div", { class: "dim" }, "(no files)"));
      return;
    }
    const rows = shown.map((f) => {
      const meta = f.user_metadata || {};
      const check = h("input", { type: "checkbox" });
      check.checked = selected.has(f.name);
      check.addEventListener("change", () => {
        if (check.checked) selected.add(f.name); else selected.delete(f.name);
      });
      const ocrBtn = h("button", { class: "ghost" }, t("files.ocr"));
      ocrBtn.addEventListener("click", guard(() => openOcrModal(f.name)));
      const dlBtn = h("a", { href: `/api/files/${encodeURIComponent(f.name)}`, download: f.name },
        h("button", { class: "ghost" }, t("files.download")));
      const delBtn = h("button", { class: "danger ghost" }, t("files.delete"));
      delBtn.addEventListener("click", guard(async () => {
        if (!confirm(`delete ${f.name}?`)) return;
        try {
          await api(`/api/files/${encodeURIComponent(f.name)}`, { method: "DELETE" });
        } catch (e) {
          // 409: referenced by knowledge bases — offer force delete
          if (String(e.message).startsWith("409") &&
              confirm(`${f.name} is referenced by a knowledge base. Delete anyway?`)) {
            await api(`/api/files/${encodeURIComponent(f.name)}?force=true`, { method: "DELETE" });
          } else if (!String(e.message).startsWith("409")) {
            throw e;
          }
        }
        selected.delete(f.name);
        await load();
      }));
      const badges = [];
      if (meta.kind) badges.push(h("span", { class: "badge" }, meta.kind));
      if (meta.is_manual_edited) badges.push(h("span", { class: "badge warn" }, t("ocr.edited")));
      if (meta.publish_date) badges.push(h("span", { class: "badge" }, meta.publish_date));
      const nameCell = h("td", { class: "clickable" }, f.name, " ", ...badges);
      nameCell.addEventListener("click", guard(() => openPreview(f)));
      return h("tr", {},
        h("td", {}, check),
        nameCell,
        h("td", { class: "dim" }, fmtBytes(f.size)),
        h("td", { class: "dim" }, f.uploaded_at ? new Date(f.uploaded_at * 1000).toLocaleString() : ""),
        h("td", { class: "dim" }, (f.etag || "").slice(0, 10)),
        h("td", {}, h("div", { class: "row" }, ocrBtn, dlBtn, delBtn)));
    });
    tableBox.appendChild(h("table", {},
      h("tr", {}, h("th", {}, selAll), sortable(t("files.name"), "name"),
        sortable(t("files.size"), "size"), sortable("uploaded", "uploaded_at"),
        h("th", {}, "etag"), h("th", {}, t("files.actions"))),
      rows));
  }

  selAll.addEventListener("change", guard(async () => {
    const data = await api("/api/files");
    const names = data.files.filter((f) => !f.name.startsWith(".meta")).map((f) => f.name);
    selected.clear();
    if (selAll.checked) names.forEach((n) => selected.add(n));
    await load();
  }));

  batchDel.addEventListener("click", guard(async () => {
    if (!selected.size) { toast("nothing selected", "err"); return; }
    if (!confirm(`delete ${selected.size} files?`)) return;
    const blocked = [];
    for (const name of [...selected]) {
      try {
        await api(`/api/files/${encodeURIComponent(name)}`, { method: "DELETE" });
        selected.delete(name);
      } catch (e) {
        // 409: referenced by a KB — collect and offer one force pass
        if (String(e.message).startsWith("409")) blocked.push(name);
        else throw e;
      }
    }
    if (blocked.length &&
        confirm(`${blocked.length} file(s) are referenced by knowledge bases:\n${blocked.join(", ")}\nDelete anyway?`)) {
      for (const name of blocked) {
        await api(`/api/files/${encodeURIComponent(name)}?force=true`, { method: "DELETE" });
        selected.delete(name);
      }
    }
    toast("deleted", "ok");
    await load();
  }));

  searchIn.addEventListener("input", guard(async () => { page = 0; await load(); }));
  prevBtn.addEventListener("click", guard(async () => { page = Math.max(0, page - 1); await load(); }));
  nextBtn.addEventListener("click", guard(async () => { page += 1; await load(); }));

  upBtn.addEventListener("click", guard(async () => {
    if (!fileInput.files.length) return;
    for (const f of fileInput.files) {
      const fd = new FormData();
      fd.append("file", f);
      await fetch("/api/files/upload", { method: "POST", body: fd });
    }
    toast(`uploaded ${fileInput.files.length} file(s)`, "ok");
    await load();
  }));

  // Poll one progress task into a live card. Tasks persist in
  // localStorage so an in-flight upload's card survives a page reload
  // (ref file-manager.js saveUploadTask/getStoredUploadTasks:18-60).
  function trackUpload(taskId, filename) {
    saveUploadTask(taskId, filename);
    const bar = h("div", {});
    const stage = h("div", { class: "stage" }, "PENDING");
    const prog = h("div", { class: "col" },
      h("div", { class: "dim" }, filename),
      h("div", { class: "progress" }, bar), stage);
    progWrap.appendChild(prog);
    const timer = setInterval(guard(async () => {
      let s;
      try {
        s = await api(`/api/files/upload-progress/${taskId}`);
      } catch {
        // task evicted server-side (restart) — drop the stale card
        clearInterval(timer);
        removeUploadTask(taskId);
        prog.remove();
        return;
      }
      bar.style.width = `${s.progress}%`;
      const idx = STAGES.indexOf(s.status);
      stage.textContent = `${s.status} (${s.progress}%)` +
        (idx >= 0 ? ` · stage ${idx + 1}/${STAGES.length}` : "");
      if (s.status === "COMPLETED" || s.status === "FAILED") {
        clearInterval(timer);
        removeUploadTask(taskId);
        stage.textContent = s.status === "FAILED" ? `FAILED: ${s.error}` : "COMPLETED";
        if (s.status === "COMPLETED") toast(`processed ${filename}`, "ok");
        await load();
        setTimeout(() => prog.remove(), 4000);
      }
    }), 500);
  }

  upProgBtn.addEventListener("click", guard(async () => {
    const f = fileInput.files[0];
    if (!f) return;
    const fd = new FormData();
    fd.append("file", f);
    const r = await fetch("/api/files/upload-with-progress", { method: "POST", body: fd });
    const { task_id } = await r.json();
    trackUpload(task_id, f.name);
  }));

  // resume cards for uploads still running from a previous page view
  for (const { task_id, filename } of getStoredUploadTasks()) {
    trackUpload(task_id, filename);
  }

  view.appendChild(h("div", { class: "col" },
    h("div", { class: "card" },
      h("div", { class: "row" }, fileInput, upBtn, upProgBtn), progWrap),
    h("div", { class: "card col" },
      h("div", { class: "row" }, searchIn, prevBtn, pager, nextBtn, batchDel, summary),
      tableBox)));
  await load();
}

// ------------------------------------------------------------------ preview
// Click a file name → content preview: markdown rendered, CSV as a table,
// text/code in a <pre> (ref file-manager preview flows).

async function openPreview(f) {
  const name = f.name;
  const ext = (name.match(/\.[^.]+$/) || [""])[0].toLowerCase();
  if (!PREVIEW_EXTS.includes(ext)) {
    toast(t("files.noPreview"), "err");
    return;
  }
  const resp = await fetch(`/api/files/${encodeURIComponent(name)}`);
  if (!resp.ok) { toast(`HTTP ${resp.status}`, "err"); return; }
  const text = await resp.text();
  const clipped = text.slice(0, 40000);
  let body;
  if (ext === ".md" || ext === ".markdown") {
    body = renderMarkdown(clipped);
  } else if (ext === ".csv") {
    body = csvTable(clipped);
  } else {
    body = h("pre", { style: "max-height:60vh;overflow:auto" }, clipped);
  }
  openModal(h("div", {},
    h("div", { class: "row" },
      h("h2", {}, name),
      h("span", { class: "dim" }, fmtBytes(f.size)),
      h("div", { class: "spacer" }),
      h("button", { class: "ghost", onclick: closeModal }, "✕")),
    text.length > clipped.length ? h("div", { class: "dim" }, "(truncated preview)") : null,
    body));
}

// ------------------------------------------------------------------ OCR modal

async function openOcrModal(name) {
  let data;
  try {
    data = await api(`/api/files/${encodeURIComponent(name)}/ocr`);
  } catch (e) {
    toast(t("ocr.none"), "err");
    return;
  }
  let pageIdx = 0;
  const pageBar = h("div", { class: "tabs-inner" });
  const editor = h("textarea", {});
  const layoutBox = h("div", {});
  const editedBadge = h("span", { class: "badge warn", style: "display:none" }, t("ocr.edited"));
  const saveBtn = h("button", { class: "primary" }, t("ocr.save"));
  const structBox = h("details", {}, h("summary", { class: "dim" }, "structured data"), h("pre", {}));

  function showPage(i) {
    pageIdx = i;
    const p = data.pages[i];
    editor.value = p.markdown_text || "";
    editedBadge.style.display = p.is_manual_edited ? "" : "none";
    pageBar.querySelectorAll("button").forEach((b, j) => b.classList.toggle("active", j === i));
    layoutBox.innerHTML = "";
    if (p.layout_image_url) {
      layoutBox.appendChild(h("img", { class: "layout", src: p.layout_image_url, alt: "layout overlay" }));
    }
    const pre = structBox.querySelector("pre");
    pre.textContent = p.structured_data ? JSON.stringify(p.structured_data, null, 2) : "(none)";
  }

  data.pages.forEach((p, i) => {
    const b = h("button", {}, `page ${p.page_num}`);
    b.addEventListener("click", () => showPage(i));
    pageBar.appendChild(b);
  });

  saveBtn.addEventListener("click", guard(async () => {
    await api(`/api/files/${encodeURIComponent(name)}/ocr`, {
      method: "PUT",
      body: JSON.stringify({ page_num: data.pages[pageIdx].page_num, markdown_text: editor.value }),
    });
    toast("OCR page saved — next build picks it up", "ok");
    data = await api(`/api/files/${encodeURIComponent(name)}/ocr`);
    showPage(pageIdx);
  }));

  openModal(h("div", {},
    h("div", { class: "row" },
      h("h2", {}, `OCR · ${name}`), editedBadge, h("div", { class: "spacer" }),
      h("button", { class: "ghost", onclick: closeModal }, "✕")),
    data.is_multi_page ? pageBar : null,
    h("div", { class: "row", style: "align-items:flex-start" },
      h("div", { style: "flex:1;min-width:0" }, editor, h("div", { class: "row", style: "margin-top:8px" }, saveBtn)),
      h("div", { style: "width:300px" }, layoutBox, structBox))));
  showPage(0);
}
