"""Trajectory replay server: re-stream a recorded agent run over WebSocket, on the port.

Parity surface: ``scripts/utils/replay_server.py`` in the reference (a
tornado WS server that replays a pickled event stream at a fixed interval
for UI demos/debugging). Here the source of truth is the trajectory DB the
agents already write (``TrajectoryRecord.trajectory``) — no pickle files —
and replayed events use the exact card protocol of the live chat WS
(``api/app.py ChatWebSocketHandler``), so the SPA chat view and any client
built for it render replays unchanged. No device is involved.

    python -m youtu_rag_tpu_torch.replay_server --db /tmp/yrt/yrt.db --port 8099
    # open ws://localhost:8099/ws, send {"query": "<anything>"}; or browse /
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

import tornado.ioloop
import tornado.web
import tornado.websocket

from .db.models import TrajectoryRecord
from .db.service import DBService

PAGE = """<!doctype html><meta charset="utf-8"><title>replay</title>
<style>body{font-family:monospace;margin:2em;max-width:60em}
.ev{margin:.2em 0;padding:.3em .5em;border-left:3px solid #888;background:#f6f6f6}
.tool_call{border-color:#c80}.tool_output{border-color:#08c}.final{border-color:#0a0}
</style>
<h2>trajectory replay</h2>
<p>runs: <select id="runs"></select>
<button onclick="play()">replay</button></p><div id="log"></div>
<script>
fetch('/api/replays').then(r=>r.json()).then(d=>{
  runs.innerHTML=d.runs.map(r=>`<option value="${r.trace_id}">${r.trace_id} — ${r.input.slice(0,60)}</option>`).join('')});
function play(){
  log.innerHTML='';
  const ws=new WebSocket(`ws://${location.host}/ws`);
  ws.onopen=()=>ws.send(JSON.stringify({trace_id:runs.value,query:'replay'}));
  ws.onmessage=e=>{const c=JSON.parse(e.data);
    const d=document.createElement('div');d.className='ev '+c.type;
    d.textContent=`[${c.type}] ${c.name||''} ${c.content||''}`;log.appendChild(d);};}
</script>"""


def cards_from_trajectory(rec: TrajectoryRecord) -> list[dict]:
    """Turn a stored trajectory (message list) back into live-protocol cards."""
    cards: list[dict] = []
    for msg in rec.trajectory or []:
        role = msg.get("role")
        if role == "tool":
            cards.append(
                {"type": "tool_call", "name": msg.get("name", ""), "content": msg.get("arguments", "")}
            )
            cards.append(
                {"type": "tool_output", "name": msg.get("name", ""), "content": msg.get("output", "")}
            )
        elif role == "assistant":
            cards.append({"type": "text_delta", "content": msg.get("content", "")})
        elif role == "user":
            cards.append({"type": "plan", "name": "user", "content": msg.get("content", "")})
    if rec.output:
        cards.append({"type": "final", "content": rec.output})
    if rec.error:
        cards.append({"type": "error", "content": rec.error})
    return cards


class ReplayListHandler(tornado.web.RequestHandler):
    def get(self):
        db: DBService = self.application.settings["db"]
        runs = db.select(TrajectoryRecord, limit=200)
        self.set_header("Content-Type", "application/json")
        self.write(
            json.dumps(
                {"runs": [{"trace_id": r.trace_id, "input": r.input or ""} for r in runs]}
            )
        )


class IndexHandler(tornado.web.RequestHandler):
    def get(self):
        self.write(PAGE)


class ReplayWSHandler(tornado.websocket.WebSocketHandler):
    def check_origin(self, origin):
        return True

    async def on_message(self, message):
        try:
            body = json.loads(message)
        except json.JSONDecodeError:
            await self.write_message(json.dumps({"type": "error", "content": "invalid JSON"}))
            return
        db: DBService = self.application.settings["db"]
        interval: float = self.application.settings["interval"]
        trace_id = body.get("trace_id")
        rows = (
            db.select(TrajectoryRecord, where={"trace_id": trace_id}, limit=1)
            if trace_id
            else db.select(TrajectoryRecord, limit=1)
        )
        if not rows:
            await self.write_message(
                json.dumps({"type": "error", "content": f"no recorded run {trace_id!r}"})
            )
            return
        for card in cards_from_trajectory(rows[0]):
            await asyncio.sleep(interval)
            try:
                await self.write_message(json.dumps(card, ensure_ascii=False))
            except tornado.websocket.WebSocketClosedError:
                return
        await self.write_message(json.dumps({"type": "done", "trace_id": rows[0].trace_id}))


def make_app(db: DBService, interval: float) -> tornado.web.Application:
    return tornado.web.Application(
        [(r"/", IndexHandler), (r"/api/replays", ReplayListHandler), (r"/ws", ReplayWSHandler)],
        db=db,
        interval=interval,
    )


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--db", default=None, help="sqlite path or sqlite:/// url (default: YRT_DB_URL)")
    p.add_argument("--port", type=int, default=8099)
    p.add_argument("--interval", type=float, default=0.3, help="seconds between replayed events")
    args = p.parse_args()

    db = DBService(args.db)
    if not db.available:
        sys.exit("no trajectory DB (pass --db or set YRT_DB_URL)")
    app = make_app(db, args.interval)
    app.listen(args.port)
    print(f"replay server on http://localhost:{args.port}/ (ws at /ws)")
    tornado.ioloop.IOLoop.current().start()


if __name__ == "__main__":
    main()
