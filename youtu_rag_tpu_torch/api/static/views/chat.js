// Chat view: SSE card rendering for the full event vocabulary
// (text_delta / reasoning_delta / tool_call / tool_output / plan / memory /
//  report / final / error / done — ref: chat_service SSE card protocol),
// markdown answer rendering with retrieval-context source cards, message
// actions (copy / retry), per-tab conversation persistence, thinking timer,
// and an in-chat file sidebar that renders attached / cited files by type
// (markdown, CSV-as-table, images, plain text — ref chat.js
// openChatFileSidebar/renderCSVInSidebar/renderImageInSidebar:2138-2533).
// Counterpart of rag_webui's components/chat.js.

import { api, fmtBytes, guard, h, state, t, toast } from "../app.js";
import { csvTable, renderMarkdown } from "./utils.js";
import {
  pwinKey as pwinKeyOf, pwinStatusText, sidebarKind, sourceFileOf,
  splitContexts, workflowNodes,
} from "./transforms.js";

export { sourceFileOf, splitContexts };

const HIST_KEY = "yrt-chat-history";

function loadHistory() {
  try { return JSON.parse(sessionStorage.getItem(HIST_KEY)) || []; } catch { return []; }
}

function saveHistory(hist) {
  sessionStorage.setItem(HIST_KEY, JSON.stringify(hist.slice(-40)));
}

export async function renderChat(view) {
  const log = h("div", { id: "chat-log" });
  const kbSel = h("select", { id: "chat-kb" });
  const agentSel = h("select", { id: "chat-agent" });
  const memToggle = h("input", { type: "checkbox" });
  const autoToggle = h("input", { type: "checkbox", title: "LLM picks the agent per query" });
  const input = h("input", { placeholder: t("chat.placeholder"), autocomplete: "off" });
  const sendBtn = h("button", { class: "primary", type: "submit" }, t("chat.send"));
  // stop button (ref chat.js stopAgent): aborts the SSE fetch client-side;
  // the server tears the run down on disconnect
  const stopBtn = h("button", { class: "ghost", type: "button", style: "display:none" }, t("chat.stop"));
  const clearBtn = h("button", { class: "ghost" }, t("chat.clear"));

  const fileBox = h("div", { class: "col" });
  // in-chat upload (ref chat.js handleFileUploadClick → associate flow):
  // picked file uploads immediately and joins the attachable list checked
  const chatUpload = h("input", { type: "file", style: "display:none" });
  const chatUploadBtn = h("button", { class: "ghost" }, "+ upload");
  chatUploadBtn.addEventListener("click", () => chatUpload.click());
  chatUpload.addEventListener("change", guard(async () => {
    const f = chatUpload.files[0];
    if (!f) return;
    const fd = new FormData();
    fd.append("file", f);
    const r = await fetch("/api/files/upload", { method: "POST", body: fd });
    if (!r.ok) { toast(`upload failed: ${r.status}`, "err"); return; }
    toast(`uploaded ${f.name}`, "ok");
    fileBox.appendChild(fileLabel(ctx, f.name, true));
    chatUpload.value = "";
  }));
  const side = h("div", { class: "chat-side col" },
    h("div", { class: "card col" },
      h("h3", {}, t("chat.kb")), kbSel, kbHint,
      h("h3", {}, t("chat.agent")), agentSel,
      h("label", { class: "dim" }, autoToggle, " auto-select"),
      h("h3", {}, t("chat.memory")),
      h("label", { class: "dim" }, memToggle, " enabled"),
      h("h3", {}, "attach files"), fileBox, chatUploadBtn, chatUpload,
      clearBtn,
    ),
  );

  // in-chat file sidebar (ref chat.js openChatFileSidebar): renders a
  // clicked attachment / cited source file inline next to the conversation
  const sidebar = h("div", { class: "file-sidebar col", style: "display:none" });

  const ctx = { log, kbSel, fileBox, autoToggle, sidebar, hist: loadHistory(), abort: null };

  // run elapsed-time display (ref chat.js startTotalTimeTimer)
  const runTimer = h("span", { class: "dim run-timer" });
  // KB send-gate hint (ref chat.js AGENT_KB_REQUIREMENTS/updateKbSelectorHint)
  const kbHint = h("span", { class: "dim kb-hint" });

  const form = h("form", { id: "composer" }, input, sendBtn, stopBtn, runTimer);
  stopBtn.addEventListener("click", () => {
    if (ctx.abort) ctx.abort.abort();
  });

  // IME composition guard (ref chat.js handleCompositionStart/End +
  // handleChatInputKeydown): Enter mid-composition commits the candidate,
  // it must not submit the form.
  let composing = false;
  input.addEventListener("compositionstart", () => { composing = true; });
  input.addEventListener("compositionend", () => { composing = false; });
  input.addEventListener("keydown", (ev) => {
    if (ev.key === "Enter" && (composing || ev.isComposing)) {
      ev.preventDefault();
      ev.stopPropagation();
    }
  });

  form.addEventListener("submit", guard(async (ev) => {
    ev.preventDefault();
    const q = input.value.trim();
    if (!q) return;
    input.value = "";
    stopBtn.style.display = "";
    sendBtn.disabled = true;
    const t0 = Date.now();
    runTimer.textContent = "0.0s";
    const tick = setInterval(() => {
      runTimer.textContent = `${((Date.now() - t0) / 1000).toFixed(1)}s`;
    }, 250);
    try {
      await send(ctx, q);
    } finally {
      clearInterval(tick);
      runTimer.textContent = `done in ${((Date.now() - t0) / 1000).toFixed(1)}s`;
      stopBtn.style.display = "none";
      sendBtn.disabled = false;
      updateSendGate();
      ctx.abort = null;
    }
  }));

  // agents whose catalog entry declares requires_kb can't run without a
  // selected knowledge base — disable send + explain (ref chat.js
  // updateSendButtonState:39-72)
  let kbRequiredTypes = new Set();
  function updateSendGate() {
    const needsKb = kbRequiredTypes.has(agentSel.value) && !kbSel.value;
    sendBtn.disabled = needsKb;
    kbHint.textContent = needsKb ? t("chat.needKb") : "";
  }

  clearBtn.addEventListener("click", () => {
    ctx.hist = [];
    saveHistory(ctx.hist);
    log.innerHTML = "";
  });

  view.appendChild(h("div", { class: "chat-wrap" },
    h("div", { class: "chat-main" }, log, form), sidebar, side));

  // restore the conversation (per browser tab — ref chat.js history restore)
  for (const m of ctx.hist) {
    if (m.role === "user") userBubble(ctx, m.text, { record: false });
    else botBubble(ctx, m.text);
  }
  log.scrollTop = log.scrollHeight;

  // populate selectors
  const [kbs, agents, mem, files] = await Promise.all([
    api("/api/knowledge-bases"), api("/api/agents"), api("/api/memory/config"),
    api("/api/files"),
  ]);
  const attachable = files.files.filter((f) => !f.name.startsWith(".meta")).slice(0, 12);
  if (!attachable.length) fileBox.appendChild(h("span", { class: "dim" }, "(no uploads)"));
  for (const f of attachable) fileBox.appendChild(fileLabel(ctx, f.name, false));
  kbSel.innerHTML = "";
  kbSel.appendChild(h("option", { value: "" }, "(no knowledge base)"));
  for (const kb of kbs.knowledge_bases) kbSel.appendChild(h("option", {}, kb.name));
  kbSel.value = state.kb || "";
  kbSel.addEventListener("change", () => {
    state.kb = kbSel.value;
    localStorage.setItem("yrt-kb", state.kb);
    updateSendGate();
  });
  for (const a of agents.available_types) agentSel.appendChild(h("option", {}, a));
  agentSel.value = agents.current.type;
  kbRequiredTypes = new Set((agents.catalog || [])
    .filter((a) => a.requires_kb).map((a) => a.type));
  updateSendGate();
  agentSel.addEventListener("change", guard(async () => {
    await api("/api/agents/switch", { method: "POST", body: JSON.stringify({ type: agentSel.value }) });
    toast(`agent → ${agentSel.value}`, "ok");
    updateSendGate();
  }));
  memToggle.checked = !!mem.memoryEnabled;
  memToggle.addEventListener("change", guard(async () => {
    await api("/api/memory/config", { method: "POST", body: JSON.stringify({ memoryEnabled: memToggle.checked }) });
  }));
  input.focus();
}

// ------------------------------------------------------------- file sidebar
// Ref chat.js openChatFileSidebar/renderTextInSidebar/renderCSVInSidebar/
// renderImageInSidebar (2138-2533): click a cited or attached file → a side
// panel renders it by type without leaving the conversation.

const SIDEBAR_CLIP = 60000;

function fileLabel(ctx, name, checked) {
  const nameEl = h("span", { class: "clickable" }, name);
  nameEl.addEventListener("click", guard((ev) => {
    ev.preventDefault();
    return openFileSidebar(ctx, name);
  }));
  const attrs = { type: "checkbox", value: name };
  if (checked) attrs.checked = "";
  return h("label", { class: "dim row", style: "gap:6px" }, h("input", attrs), nameEl);
}

export async function openFileSidebar(ctx, name) {
  const sb = ctx.sidebar;
  if (!sb) return;
  const body = h("div", { class: "file-sidebar-body" }, h("span", { class: "dim" }, "loading…"));
  const closeB = h("button", { class: "ghost" }, "✕");
  closeB.addEventListener("click", () => { sb.style.display = "none"; sb.innerHTML = ""; });
  sb.innerHTML = "";
  sb.appendChild(h("div", { class: "row" },
    h("h3", { style: "margin:0;overflow:hidden;text-overflow:ellipsis" }, `📄 ${name}`),
    h("div", { class: "spacer" }), closeB));
  sb.appendChild(body);
  sb.style.display = "";
  const resp = await fetch(`/api/files/${encodeURIComponent(name)}`);
  body.innerHTML = "";
  if (!resp.ok) {
    body.appendChild(h("div", { class: "dim" }, `not available (HTTP ${resp.status})`));
    return;
  }
  const kind = sidebarKind(name);
  if (kind === "image") {
    const blob = await resp.blob();
    body.appendChild(h("img", {
      class: "layout", src: URL.createObjectURL(blob), alt: name,
    }));
    body.appendChild(h("div", { class: "dim" }, fmtBytes(blob.size)));
    return;
  }
  const text = await resp.text();
  const clipped = text.slice(0, SIDEBAR_CLIP);
  if (kind === "csv") {
    body.appendChild(csvTable(clipped));
  } else if (kind === "markdown") {
    body.appendChild(renderMarkdown(clipped));
  } else if (kind === "json") {
    let pretty = clipped;
    try { pretty = JSON.stringify(JSON.parse(text), null, 2).slice(0, SIDEBAR_CLIP); } catch { /* keep raw */ }
    body.appendChild(h("pre", {}, pretty));
  } else {
    body.appendChild(h("pre", {}, clipped));
  }
  if (text.length > clipped.length) {
    body.appendChild(h("div", { class: "dim" }, "(truncated)"));
  }
}

// ------------------------------------------------------------- bubbles

function copyBtn(getText) {
  const b = h("button", { class: "ghost", title: "copy" }, "⧉");
  b.addEventListener("click", () => {
    navigator.clipboard?.writeText(getText()).then(
      () => toast("copied", "ok"), () => toast("copy failed", "err"));
  });
  return b;
}

function userBubble(ctx, text, { record = true } = {}) {
  if (record) {
    ctx.hist.push({ role: "user", text });
    saveHistory(ctx.hist);
  }
  const retry = h("button", { class: "ghost", title: t("chat.retry") }, "↻");
  retry.addEventListener("click", guard(() => send(ctx, text)));
  const el = h("div", { class: "msg user" }, text,
    h("div", { class: "actions" }, copyBtn(() => text), retry));
  ctx.log.appendChild(el);
  ctx.log.scrollTop = ctx.log.scrollHeight;
  return el;
}

function botBubble(ctx, text) {
  const { body, sources } = splitContexts(text);
  const el = h("div", { class: "msg bot" });
  el.appendChild(renderMarkdown(body || text));
  for (const s of sources) {
    const summary = h("summary", {}, `📄 ${s.title}`);
    // cited source file → sidebar (ref chat.js source-chip click-through)
    const src = sourceFileOf(s.content);
    if (src) {
      const chip = h("button", { class: "ghost src-chip", type: "button" }, src);
      chip.addEventListener("click", guard((ev) => {
        ev.preventDefault();
        ev.stopPropagation();
        return openFileSidebar(ctx, src);
      }));
      summary.appendChild(chip);
    }
    el.appendChild(h("details", { class: "src-card" }, summary,
      renderMarkdown(s.content)));
  }
  el.appendChild(h("div", { class: "actions" }, copyBtn(() => text)));
  ctx.log.appendChild(el);
  ctx.log.scrollTop = ctx.log.scrollHeight;
  return el;
}

function card(log, cls, title, body = null, open = false) {
  const det = h("details", open ? { open: "" } : {},
    h("summary", {}, title),
    body ? h("pre", {}, body) : null);
  const el = h("div", { class: `card-ev ${cls}` }, det);
  log.appendChild(el);
  log.scrollTop = log.scrollHeight;
  return el;
}

// ------------------------------------------------------------- streaming

async function send(ctx, q) {
  const { log, kbSel, fileBox } = ctx;
  const kb = kbSel.value;
  const fileIds = [...fileBox.querySelectorAll("input:checked")].map((c) => c.value);
  userBubble(ctx, q + (fileIds.length ? `\n📎 ${fileIds.join(", ")}` : ""));
  const body = { query: q, stream: true };
  if (kb) body.kb_id = kb;
  if (fileIds.length) body.file_ids = fileIds;
  if (ctx.autoToggle && ctx.autoToggle.checked) body.auto_select = true;
  ctx.abort = new AbortController();
  let resp;
  try {
    resp = await fetch("/api/chat", {
      method: "POST", body: JSON.stringify(body), signal: ctx.abort.signal,
    });
  } catch (e) {
    if (e.name === "AbortError") { card(log, "", t("chat.stopped")); return; }
    throw e;
  }
  if (!resp.ok) { card(log, "error", `HTTP ${resp.status}`); return; }
  const reader = resp.body.getReader();
  const decoder = new TextDecoder();
  let stream = null;       // plain-text element while deltas stream
  let streamText = "";
  let reasoning = null, reasoningT0 = 0, reasoningTimer = null;
  let buf = "";
  const toolCards = [];  // FIFO: tool_output pairs with the oldest open call
  // parallel-orchestrator windows (ref chat.js parallel grid): one pane
  // per task, live-updated from worker events tagged data.parallel_agent
  const pwins = new Map();  // "group:task_idx" -> {el, body, status, tools}
  let mergeCard = null;
  let workflowEl = null;    // in-place workflow tree (ref workflow_update)
  try {
    for (;;) {
      const { done, value } = await reader.read();
      if (done) break;
      buf += decoder.decode(value, { stream: true });
      let idx;
      while ((idx = buf.indexOf("\n\n")) >= 0) {
        const line = buf.slice(0, idx); buf = buf.slice(idx + 2);
        if (!line.startsWith("data:")) continue;
        let ev;
        try { ev = JSON.parse(line.slice(5)); } catch { continue; }
        handleCard(ev);
      }
    }
  } catch (e) {
    if (e.name !== "AbortError") throw e;
    card(log, "", t("chat.stopped"));
  }
  finishStream();  // connection closed without a done card — still render

  function stopReasoningTimer(final = true) {
    if (reasoningTimer) { clearInterval(reasoningTimer); reasoningTimer = null; }
    if (reasoning && final && reasoningT0) {
      const secs = ((Date.now() - reasoningT0) / 1000).toFixed(1);
      reasoning.querySelector("summary").textContent = `${t("chat.thought")} (${secs}s)`;
    }
  }

  function finishStream() {
    stopReasoningTimer();
    if (stream && streamText) {
      // streamed plain text → final markdown + source cards
      stream.remove();
      botBubble(ctx, streamText);
      ctx.hist.push({ role: "bot", text: streamText });
      saveHistory(ctx.hist);
      stream = null; streamText = "";
    }
  }

  // ----------------------------------------------- parallel windows

  function makeGroup(d) {
    const grid = h("div", { class: "parallel-grid" });
    const wrap = h("div", { class: "parallel-group" },
      h("div", { class: "pgroup-head" },
        `⫸ parallel group ${(d.group ?? 0) + 1} · ${(d.tasks || []).length} tasks`),
      grid);
    log.appendChild(wrap);
    (d.tasks || []).forEach((task, i) => {
      const status = h("span", { class: "pwin-status" }, "…");
      const body = h("div", { class: "pwin-body" },
        h("div", { class: "dim" }, task.task || ""));
      const el = h("div", { class: "pwin" },
        h("div", { class: "pwin-head" },
          h("span", { class: "pwin-name" }, `🤖 ${task.agent_name}`), status),
        body);
      grid.appendChild(el);
      pwins.set(`${d.group ?? 0}:${i}`, { el, body, status, tools: [] });
    });
    log.scrollTop = log.scrollHeight;
  }

  function pwinRoute(ev) {
    const w = pwins.get(pwinKeyOf(ev.data));
    if (!w) return;
    switch (ev.type) {
      case "text_delta": {
        let pre = w.body.querySelector(".pwin-stream");
        if (!pre) { pre = h("pre", { class: "pwin-stream" }); w.body.appendChild(pre); }
        pre.textContent += ev.content || "";
        break;
      }
      case "reasoning_delta": {
        let det = w.body.querySelector(".pwin-reasoning");
        if (!det) {
          det = h("details", { class: "pwin-reasoning" },
            h("summary", {}, t("chat.thinking")), h("pre"));
          w.body.appendChild(det);
        }
        det.querySelector("pre").textContent += ev.content || "";
        break;
      }
      case "tool_call": {
        const det = h("details", { class: "pwin-tool" },
          h("summary", {}, `→ ${ev.name}`),
          ev.arguments ? h("pre", {}, ev.arguments) : null);
        w.body.appendChild(det);
        w.tools.push(det);
        break;
      }
      case "tool_output": {
        const det = w.tools.shift();
        const text = (ev.content || "").slice(0, 1200);
        if (det) det.appendChild(h("pre", {}, text));
        break;
      }
      default:
        break;
    }
    w.body.scrollTop = w.body.scrollHeight;
  }

  function pwinStatus(ev) {
    const d = ev.data || {};
    const w = pwins.get(pwinKeyOf(d));
    if (!w) return;
    w.status.textContent = pwinStatusText(d);
    if (d.status === "start") {
      w.el.classList.add("running");
    } else if (d.status === "done") {
      w.el.classList.remove("running");
      w.el.classList.add("done");
      const pre = w.body.querySelector(".pwin-stream");
      if (pre) pre.remove();
      if (d.result) w.body.appendChild(h("div", { class: "pwin-result" },
        renderMarkdown(d.result)));
    } else {  // failed | timeout
      w.el.classList.remove("running");
      w.el.classList.add("failed");
      if (d.error) w.body.appendChild(h("div", { class: "pwin-error" }, d.error));
    }
    w.body.scrollTop = w.body.scrollHeight;
  }

  function handleCard(ev) {
    // worker events tagged by the parallel orchestrator route into the
    // matching task window instead of the main stream
    if (ev.data && ev.data.parallel_agent) { pwinRoute(ev); return; }
    switch (ev.type) {
      case "text_delta":
        if (!stream) {
          stream = h("div", { class: "msg bot" });
          log.appendChild(stream);
        }
        streamText += ev.content || "";
        stream.textContent = streamText;
        log.scrollTop = log.scrollHeight;
        break;
      case "reasoning_delta":
        if (!reasoning) {
          reasoning = card(log, "reasoning", `${t("chat.thinking")} (0.0s)`, "", false);
          reasoningT0 = Date.now();
          reasoningTimer = setInterval(() => {
            const secs = ((Date.now() - reasoningT0) / 1000).toFixed(1);
            reasoning.querySelector("summary").textContent = `${t("chat.thinking")} (${secs}s)`;
          }, 250);
        }
        if (!reasoning.querySelector("pre")) reasoning.querySelector("details").appendChild(h("pre"));
        reasoning.querySelector("pre").textContent += ev.content || "";
        break;
      case "tool_call": {
        const c = card(log, "tool", `→ ${ev.name}`, ev.arguments || "", false);
        toolCards.push(c);
        break;
      }
      case "tool_output": {
        const c = toolCards.shift();
        const text = (ev.content || "").slice(0, 2000);
        if (c) c.querySelector("details").appendChild(h("pre", {}, text));
        else card(log, "tool", `← ${ev.name || "output"}`, text);
        break;
      }
      case "plan":
        card(log, "", "plan", JSON.stringify(ev.data || ev.content || {}, null, 2));
        break;
      case "workflow_update": {
        // live plan tree, updated in place (ref workflow visualization)
        if (!workflowEl) {
          workflowEl = h("div", { class: "card-ev workflow" });
          log.appendChild(workflowEl);
        }
        workflowEl.innerHTML = "";
        for (const n of workflowNodes(ev.data)) {
          workflowEl.appendChild(h("div", { class: `wf-node ${n.status}` },
            h("span", { class: "wf-icon" }, n.icon),
            h("span", { class: "wf-agent" }, n.agent),
            h("span", { class: "dim" }, ` ${n.task}`)));
        }
        log.scrollTop = log.scrollHeight;
        break;
      }
      case "parallel_group":
        if (ev.data?.status === "start") makeGroup(ev.data);
        break;
      case "parallel_task":
        pwinStatus(ev);
        break;
      case "merge":
        if (ev.data?.status === "start") {
          mergeCard = card(log, "", "⧉ merging parallel results…");
        } else if (mergeCard) {
          mergeCard.querySelector("summary").textContent = "⧉ results merged";
        }
        break;
      case "memory":
        card(log, "memory", "memory context", ev.content || "");
        break;
      case "agent_switch":
        card(log, "", `agent → ${ev.content || ""}`);
        break;
      case "report":
      case "final":
        if (ev.content && !streamText) streamText = ev.content;
        if (!stream && streamText) {
          stream = h("div", { class: "msg bot" }, streamText);
          log.appendChild(stream);
        }
        break;
      case "error":
        stopReasoningTimer(false);
        card(log, "error", "error", ev.content || "", true);
        break;
      case "done":
        if (ev.trace_id) card(log, "", `done · trace ${ev.trace_id}`);
        finishStream();
        reasoning = null;
        break;
      default:
        break;
    }
  }
}
