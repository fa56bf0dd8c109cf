// Trajectories view: browse recent agent runs with a full detail modal
// (tool-call trail, token usage, errors). Counterpart of the reference's
// trajectory screens over utu/db (TrajectoryModel rows) and the replay
// tooling (scripts/replay_server.py serves the same records).

import { api, closeModal, h, openModal, t } from "../app.js";

function fmtTime(ts) {
  if (!ts) return "";
  try { return new Date(ts * 1000).toLocaleString(); } catch { return String(ts); }
}

function detailModal(r) {
  const tools = (r.tool_calls || []).map((c, i) =>
    h("div", { class: "card" },
      h("div", { class: "row" },
        h("span", { class: "badge" }, `#${i + 1}`),
        h("strong", {}, c.name || c.tool || "tool")),
      c.arguments ? h("pre", {}, typeof c.arguments === "string" ? c.arguments : JSON.stringify(c.arguments, null, 2)) : null,
      c.output ? h("pre", { class: "dim" }, String(c.output).slice(0, 1200)) : null));
  openModal(h("div", {},
    h("h2", {}, t("traj.detail")),
    h("div", { class: "dim" }, `${r.trace_id || ""} · ${fmtTime(r.created_at)}`),
    h("h3", {}, t("traj.input")), h("pre", {}, r.input || "(empty)"),
    h("h3", {}, t("traj.output")),
    r.error
      ? h("pre", { class: "err" }, r.error)
      : h("pre", {}, r.output || "(empty)"),
    tools.length ? h("h3", {}, `${t("traj.tools")} (${tools.length})`) : null,
    ...tools,
    h("div", { class: "dim" },
      `tokens: ${r.usage_input_tokens || 0} in / ${r.usage_output_tokens || 0} out`),
    h("button", { onclick: closeModal }, "close")));
}

export async function renderTrajectories(view) {
  const listBox = h("div", {});
  const limitIn = h("input", {
    type: "number", value: "50", min: "1", max: "500", style: "width:80px",
  });
  const refresh = h("button", {}, t("traj.refresh"));

  async function load() {
    listBox.innerHTML = "";
    const data = await api(`/api/trajectories?limit=${parseInt(limitIn.value, 10) || 50}`);
    if (!data.available) {
      listBox.appendChild(h("div", { class: "dim" },
        "trajectory DB not configured (set YRT_DB_URL to persist agent runs)"));
      return;
    }
    if (!data.trajectories.length) {
      listBox.appendChild(h("div", { class: "dim" }, "(no runs recorded yet)"));
      return;
    }
    const rows = data.trajectories.map((r) => {
      const tr = h("tr", { class: "clickable" },
        h("td", { class: "dim" }, fmtTime(r.created_at)),
        h("td", {}, (r.input || "").slice(0, 70)),
        h("td", { class: "dim" }, (r.output || "").slice(0, 70)),
        h("td", {}, r.error
          ? h("span", { class: "badge err" }, "error")
          : h("span", { class: "badge ok" }, "ok")),
        h("td", { class: "dim" }, String((r.tool_calls || []).length)),
        h("td", { class: "dim" },
          `${r.usage_input_tokens || 0}/${r.usage_output_tokens || 0}`));
      tr.addEventListener("click", () => detailModal(r));
      return tr;
    });
    listBox.appendChild(h("table", {},
      h("tr", {},
        h("th", {}, "time"), h("th", {}, t("traj.input")),
        h("th", {}, t("traj.output")), h("th", {}, "status"),
        h("th", {}, "tools"), h("th", {}, "tokens")),
      rows));
  }

  refresh.addEventListener("click", () => load().catch(() => {}));
  view.appendChild(h("div", { class: "col" },
    h("div", { class: "card" },
      h("h3", {}, t("tab.trajectories")),
      h("div", { class: "row" }, limitIn, refresh),
      listBox)));
  await load();
}
