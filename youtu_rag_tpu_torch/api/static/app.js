// SPA core: hash router, API client, i18n, toasts, modal.
// (counterpart of rag_webui's router/api/i18n assets, rebuilt small)

import { renderChat } from "./views/chat.js";
import { renderKb } from "./views/kb.js";
import { renderFiles } from "./views/files.js";
import { renderMonitor } from "./views/monitor.js";
import { renderTrajectories } from "./views/trajectories.js";
import { renderModels } from "./views/models.js";
import { renderMemory } from "./views/memory.js";

export const state = {
  lang: localStorage.getItem("yrt-lang") || "en",
  kb: localStorage.getItem("yrt-kb") || "",
};

// ---------------------------------------------------------------- i18n
const I18N = {
  en: {
    "tab.chat": "Chat", "tab.kb": "Knowledge Bases", "tab.files": "Files",
    "tab.monitor": "Monitor", "tab.trajectories": "Runs", "tab.models": "Models",
    "tab.memory": "Memory",
    "mem.search": "semantic search across memories…",
    "mem.batchDelete": "Delete selected", "mem.total": "total",
    "mem.none": "No memories yet — chat with memory enabled, or add one below.",
    "mem.content": "content", "mem.signals": "signals",
    "mem.add": "Store memory", "mem.add.title": "Add a memory",
    "mem.add.ph": "memory text…",
    "traj.detail": "Run detail", "traj.input": "input", "traj.output": "output",
    "traj.tools": "tool calls", "traj.refresh": "Refresh",
    "kb.create": "Create", "kb.name": "new knowledge base name",
    "kb.desc": "description (optional)", "kb.tier": "storage tier",
    "kb.search": "search knowledge bases…",
    "kb.none": "No knowledge bases yet — create one.",
    "kb.delete": "Delete", "kb.chunks": "chunks", "kb.backend": "backend",
    "kb.build": "Build", "kb.browse": "Chunks", "kb.qa": "QA", "kb.index": "Index",
    "kb.meta": "Metadata", "kb.snapshot": "Snapshot", "kb.query": "Query",
    "kb.tables": "Tables", "tables.sql": "Run SQL", "tables.none": "No structured tables — build a spreadsheet or database source.",
    "build.files": "Files to build (from the file manager)",
    "build.inline": "Inline document (optional)", "build.rebuild": "full rebuild",
    "build.run": "Run build", "build.logs": "Build logs",
    "build.sources": "Source configuration", "build.saveConfig": "Save selection as config",
    "build.fromConfig": "Build from config", "build.dbTest": "Test DB connection",
    "build.qaValidate": "Validate QA file", "build.qaBuild": "Index QA pairs",
    "build.pickFiles": "Choose files…", "build.confirmFiles": "Use selection",
    "chunks.search": "search chunks…", "qa.question": "question", "qa.answer": "answer",
    "qa.add": "Add pair", "qa.ask": "Ask", "qa.threshold": "threshold",
    "qa.execute": "Execute with agent", "qa.executed": "Execution result",
    "files.upload": "Upload", "files.upload.progress": "Upload with stages",
    "files.name": "name", "files.size": "size", "files.actions": "actions",
    "files.ocr": "OCR", "files.download": "Download", "files.delete": "Delete",
    "files.search": "search files\u2026", "files.batchDelete": "Delete selected",
    "files.noPreview": "no preview for this file type",
    "ocr.save": "Save page", "ocr.edited": "edited", "ocr.none": "no OCR results for this file",
    "chat.placeholder": "Ask the knowledge base…", "chat.send": "Send",
    "chat.kb": "Knowledge base", "chat.agent": "Agent", "chat.memory": "Memory",
    "chat.clear": "Clear conversation", "chat.retry": "Retry",
    "chat.stop": "■ stop", "chat.stopped": "⚠ stopped by user",
    "chat.needKb": "this agent needs a knowledge base — pick one above",
    "models.embed_title": "Embedding tester", "models.embed_btn": "Embed",
    "models.embed_ph": "one text per line…",
    "models.rerank_title": "Reranker tester", "models.rerank_btn": "Rerank",
    "models.rerank_q_ph": "query…", "models.rerank_d_ph": "one candidate per line…",
    "chat.thinking": "thinking…", "chat.thought": "thought",
    "qa.detail": "QA detail", "qa.edit": "Save edit", "qa.history": "Execution history",
    "monitor.latency": "Query latency (live)",
    "monitor.health": "Storage health", "monitor.metrics": "Metrics",
    "monitor.embed": "Embedding tester", "monitor.rerank": "Reranker tester",
    "monitor.runs": "Recent runs",
  },
  zh: {
    "tab.chat": "对话", "tab.kb": "知识库", "tab.files": "文件", "tab.monitor": "监控",
    "tab.trajectories": "运行记录", "tab.models": "模型", "tab.memory": "记忆",
    "mem.search": "语义搜索记忆…",
    "mem.batchDelete": "删除所选", "mem.total": "总数",
    "mem.none": "暂无记忆 — 开启记忆后对话，或在下方手动添加。",
    "mem.content": "内容", "mem.signals": "指标",
    "mem.add": "保存记忆", "mem.add.title": "添加记忆",
    "mem.add.ph": "记忆内容…",
    "traj.detail": "运行详情", "traj.input": "输入",
    "traj.output": "输出", "traj.tools": "工具调用", "traj.refresh": "刷新",
    "kb.create": "创建", "kb.name": "新知识库名称", "kb.none": "暂无知识库 — 创建一个。",
    "kb.desc": "描述（可选）", "kb.tier": "存储精度",
    "kb.search": "搜索知识库…",
    "kb.delete": "删除", "kb.chunks": "分块", "kb.backend": "后端",
    "kb.build": "构建", "kb.browse": "分块", "kb.qa": "问答", "kb.index": "索引",
    "kb.meta": "元数据", "kb.snapshot": "快照", "kb.query": "检索",
    "kb.tables": "数据表", "tables.sql": "执行 SQL", "tables.none": "暂无结构化表 — 先构建表格或数据库数据源。",
    "build.files": "要构建的文件（来自文件管理）", "build.inline": "内联文档（可选）",
    "build.rebuild": "全量重建", "build.run": "开始构建", "build.logs": "构建日志",
    "build.sources": "数据源配置", "build.saveConfig": "保存所选为配置",
    "build.fromConfig": "按配置构建", "build.dbTest": "测试数据库连接",
    "build.qaValidate": "校验问答文件", "build.qaBuild": "导入问答对",
    "build.pickFiles": "选择文件…", "build.confirmFiles": "使用所选",
    "chunks.search": "搜索分块…", "qa.question": "问题", "qa.answer": "答案",
    "qa.add": "添加问答对", "qa.ask": "提问", "qa.threshold": "阈值",
    "qa.execute": "执行（代理）", "qa.executed": "执行结果",
    "files.upload": "上传", "files.upload.progress": "分阶段上传",
    "files.name": "名称", "files.size": "大小", "files.actions": "操作",
    "files.ocr": "OCR", "files.download": "下载", "files.delete": "删除",
    "files.search": "搜索文件\u2026", "files.batchDelete": "删除所选",
    "files.noPreview": "该文件类型不支持预览",
    "ocr.save": "保存本页", "ocr.edited": "已编辑", "ocr.none": "该文件没有 OCR 结果",
    "chat.placeholder": "向知识库提问…", "chat.send": "发送",
    "chat.kb": "知识库", "chat.agent": "智能体", "chat.memory": "记忆",
    "chat.clear": "清空对话", "chat.retry": "重试",
    "chat.stop": "■ 停止", "chat.stopped": "⚠ 已被用户中止",
    "chat.needKb": "该智能体需要知识库 — 请在上方选择",
    "models.embed_title": "向量化测试", "models.embed_btn": "生成向量",
    "models.embed_ph": "每行一段文本…",
    "models.rerank_title": "重排测试", "models.rerank_btn": "重排",
    "models.rerank_q_ph": "查询…", "models.rerank_d_ph": "每行一个候选…",
    "chat.thinking": "思考中…", "chat.thought": "思考完成",
    "qa.detail": "问答详情", "qa.edit": "保存修改", "qa.history": "执行历史",
    "monitor.latency": "检索延迟（实时）",
    "monitor.health": "存储健康", "monitor.metrics": "指标",
    "monitor.embed": "向量化测试", "monitor.rerank": "重排测试", "monitor.runs": "最近运行",
  },
};

export function t(key) {
  return (I18N[state.lang] || I18N.en)[key] || I18N.en[key] || key;
}

function applyStaticI18n() {
  document.querySelectorAll("[data-i18n]").forEach((el) => {
    el.textContent = t(el.dataset.i18n);
  });
  document.getElementById("lang-toggle").textContent = state.lang === "en" ? "中文" : "EN";
}

// ---------------------------------------------------------------- api
export async function api(path, opts = {}) {
  const r = await fetch(path, opts);
  let body = null;
  try { body = await r.json(); } catch { /* non-JSON */ }
  if (!r.ok) {
    const reason = (body && (body.error || body.reason)) || r.statusText;
    throw new Error(`${r.status}: ${reason}`);
  }
  return body;
}

export function toast(msg, kind = "") {
  const d = document.createElement("div");
  d.className = `toast ${kind}`;
  d.textContent = msg;
  document.getElementById("toasts").appendChild(d);
  setTimeout(() => d.remove(), 5000);
}

export function guard(fn) {
  // wraps an async handler: errors surface as toasts, never silent
  return (...args) => fn(...args).catch((e) => toast(String(e.message || e), "err"));
}

// ---------------------------------------------------------------- modal
export function openModal(contentEl) {
  const root = document.getElementById("modal-root");
  root.innerHTML = "";
  const box = document.createElement("div");
  box.className = "modal";
  box.appendChild(contentEl);
  root.appendChild(box);
  root.onclick = (e) => { if (e.target === root) closeModal(); };
  return box;
}

export function closeModal() {
  document.getElementById("modal-root").innerHTML = "";
}

// ---------------------------------------------------------------- dom
export function h(tag, attrs = {}, ...children) {
  const el = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs)) {
    if (k === "class") el.className = v;
    else if (k.startsWith("on")) el.addEventListener(k.slice(2), v);
    else if (v !== null && v !== undefined) el.setAttribute(k, v);
  }
  for (const c of children.flat()) {
    if (c === null || c === undefined) continue;
    el.appendChild(typeof c === "string" ? document.createTextNode(c) : c);
  }
  return el;
}

// fmtBytes lives in views/transforms.js (pure, pytest-golden-tested);
// re-exported here because every view already imports it from app.js
export { fmtBytes } from "./views/transforms.js";

// ---------------------------------------------------------------- router
const routes = [
  [/^#\/chat/, renderChat, "chat"],
  [/^#\/kb/, renderKb, "kb"],
  [/^#\/files/, renderFiles, "files"],
  [/^#\/monitor/, renderMonitor, "monitor"],
  [/^#\/runs/, renderTrajectories, "trajectories"],
  [/^#\/models/, renderModels, "models"],
  [/^#\/memory/, renderMemory, "memory"],
];

async function route() {
  const hash = location.hash || "#/chat";
  const view = document.getElementById("view");
  for (const [re, render, tab] of routes) {
    if (re.test(hash)) {
      document.querySelectorAll("#tabs a").forEach((a) =>
        a.classList.toggle("active", a.dataset.tab === tab));
      view.innerHTML = "";
      try {
        await render(view, hash);
      } catch (e) {
        toast(String(e.message || e), "err");
      }
      return;
    }
  }
  location.hash = "#/chat";
}

async function refreshHealth() {
  try {
    const hlt = await api("/health");
    document.getElementById("health").textContent =
      `agent: ${hlt.agent_type} · memory: ${hlt.memory_enabled ? "on" : "off"}`;
  } catch { document.getElementById("health").textContent = "offline"; }
}

document.getElementById("lang-toggle").addEventListener("click", () => {
  state.lang = state.lang === "en" ? "zh" : "en";
  localStorage.setItem("yrt-lang", state.lang);
  applyStaticI18n();
  route();
});

window.addEventListener("hashchange", route);
applyStaticI18n();
refreshHealth();
setInterval(refreshHealth, 15000);
route();
