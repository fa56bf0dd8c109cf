// Shared view utilities: DOM layer over the pure transforms
// (views/transforms.js — executed by pytest through jsmini too) plus
// time-series chart interactivity. Counterpart of rag_webui's
// assets/js/utils.js + utils/markdown-utils.js.

import { h } from "../app.js";
import {
  chartGeometry, diffWords, escapeHtml, markdownToHtml, parseCsv,
} from "./transforms.js";

export { escapeHtml, parseCsv };

export function fmtDate(tsSeconds) {
  if (!tsSeconds) return "";
  const d = new Date(tsSeconds * 1000);
  return `${d.toLocaleDateString()} ${d.toLocaleTimeString()}`;
}

export function debounce(fn, ms = 250) {
  let timer = null;
  return (...args) => {
    clearTimeout(timer);
    timer = setTimeout(() => fn(...args), ms);
  };
}

export function csvTable(text, maxRows = 200) {
  const rows = parseCsv(text, maxRows + 1);
  if (!rows.length) return h("div", { class: "dim" }, "(empty)");
  return h("table", {},
    h("tr", {}, ...rows[0].map((c) => h("th", {}, c))),
    ...rows.slice(1, maxRows).map((r) => h("tr", {}, ...r.map((c) => h("td", {}, c)))));
}

// ------------------------------------------------------------- markdown
//
// DOM wrapper over transforms.markdownToHtml: the escape-first renderer is
// pure and golden-tested from Python; only the innerHTML assignment lives
// here. No raw HTML ever passes through (XSS-safety pinned by
// tests/api/test_js_transforms.py).

export function renderMarkdown(text) {
  const root = h("div", { class: "md" });
  root.innerHTML = markdownToHtml(text);
  return root;
}

// ------------------------------------------------------- line chart (SVG)
//
// Single-measure time series: one series (slot-1 hue stepped for the dark
// surface — no legend, the card title names it), 2px line, recessive
// horizontal grid, crosshair + tooltip on hover, min/max direct-labeled.

export function lineChart(points, { width = 560, height = 120, unit = "ms" } = {}) {
  const wrap = h("div", { class: "linechart" });
  const geo = chartGeometry(points, { width, height, unit });
  if (!geo) {
    wrap.appendChild(h("div", { class: "dim" }, "(collecting samples\u2026)"));
    return wrap;
  }
  const PAD = geo.pad;
  const w = geo.plotWidth;
  const vals = points.map((p) => p.value);
  const vmax = Math.max(...vals), vmin = Math.min(...vals);
  const span = vmax - vmin || 1;
  const x = (i) => PAD.l + (i / (points.length - 1)) * w;
  const y = (v) => PAD.t + (1 - (v - vmin) / span) * (height - PAD.t - PAD.b);
  const ns = "http://www.w3.org/2000/svg";
  const svg = document.createElementNS(ns, "svg");
  svg.setAttribute("viewBox", `0 0 ${width} ${height}`);
  svg.setAttribute("class", "linechart-svg");
  for (const gy of geo.grid) {
    const g = document.createElementNS(ns, "line");
    g.setAttribute("x1", PAD.l); g.setAttribute("x2", width - PAD.r);
    g.setAttribute("y1", gy); g.setAttribute("y2", gy);
    g.setAttribute("class", "grid");
    svg.appendChild(g);
  }
  const path = document.createElementNS(ns, "path");
  path.setAttribute("d", geo.path);
  path.setAttribute("class", "series");
  svg.appendChild(path);
  for (const lb of geo.labels) {
    const lbl = document.createElementNS(ns, "text");
    lbl.setAttribute("x", lb.x);
    lbl.setAttribute("y", lb.y);
    lbl.setAttribute("class", "pt-label");
    lbl.textContent = lb.text;
    svg.appendChild(lbl);
  }
  // hover layer: crosshair + tooltip
  const cross = document.createElementNS(ns, "line");
  cross.setAttribute("class", "crosshair"); cross.setAttribute("visibility", "hidden");
  cross.setAttribute("y1", PAD.t); cross.setAttribute("y2", height - PAD.b);
  svg.appendChild(cross);
  const dot = document.createElementNS(ns, "circle");
  dot.setAttribute("r", 4); dot.setAttribute("class", "hoverdot");
  dot.setAttribute("visibility", "hidden");
  svg.appendChild(dot);
  const tip = h("div", { class: "charttip", style: "visibility:hidden" });
  wrap.appendChild(svg);
  wrap.appendChild(tip);
  svg.addEventListener("mousemove", (ev) => {
    const rect = svg.getBoundingClientRect();
    const fx = ((ev.clientX - rect.left) / rect.width) * width;
    const i = Math.round(((fx - PAD.l) / w) * (points.length - 1));
    if (i < 0 || i >= points.length) return;
    const p = points[i];
    cross.setAttribute("x1", x(i)); cross.setAttribute("x2", x(i));
    cross.setAttribute("visibility", "visible");
    dot.setAttribute("cx", x(i)); dot.setAttribute("cy", y(p.value));
    dot.setAttribute("visibility", "visible");
    tip.textContent = `${p.label || ""} ${p.value % 1 ? p.value.toFixed(2) : p.value}${unit}`;
    tip.style.visibility = "visible";
    tip.style.left = `${Math.min((x(i) / width) * 100, 78)}%`;
  });
  svg.addEventListener("mouseleave", () => {
    cross.setAttribute("visibility", "hidden");
    dot.setAttribute("visibility", "hidden");
    tip.style.visibility = "hidden";
  });
  return wrap;
}

// word-level diff: DOM wrapper over transforms.diffWords (LCS) — expected
// vs executed answer on the QA-detail page (counterpart of rag_webui
// qa-detail's answer comparison).
export function renderDiff(expected, actual) {
  const box = document.createElement("div");
  box.className = "diff";
  for (const [cls, text] of diffWords(expected, actual)) {
    const el = document.createElement("span");
    el.className = cls;
    el.textContent = text;
    box.appendChild(el);
  }
  return box;
}
