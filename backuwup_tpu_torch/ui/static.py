"""Embedded web dashboard (the reference embeds its SPA with rust-embed,
``client/src/ui/mod.rs:12-26``; the assets live in ``client/static/``).

Counterpart of ``backuwup_tpu/ui/static.py``, copied so that the port
imports nothing of the JAX package: ``INDEX_HTML`` is byte-identical.

One self-contained page: WebSocket auto-reconnect (1 s), progress %,
rolling 25-sample transfer speed, peer list, logs pane, backup/restore
buttons, and backup-path config — the same surface as
``client/static/app.js:131-244`` / ``index.html:142-170``, in plain JS.
"""

INDEX_HTML = r"""<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>backuwup</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
:root { --bg:#10141a; --panel:#1a2129; --text:#e6eaf0; --dim:#8b97a5;
        --accent:#4da3ff; --ok:#43c478; --warn:#e4b343; --err:#e05252; }
* { box-sizing:border-box; }
body { margin:0; background:var(--bg); color:var(--text);
       font:14px/1.5 system-ui, sans-serif; }
.wrap { max-width:880px; margin:0 auto; padding:24px 16px; }
h1 { font-size:20px; margin:0 0 16px; }
h1 small { color:var(--dim); font-weight:normal; margin-left:8px; }
.card { background:var(--panel); border-radius:10px; padding:16px;
        margin-bottom:16px; }
.row { display:flex; gap:12px; align-items:center; flex-wrap:wrap; }
button { background:var(--accent); color:#07111d; font-weight:600;
         border:0; border-radius:8px; padding:8px 18px; cursor:pointer; }
button.secondary { background:#2a3644; color:var(--text); }
button:disabled { opacity:.45; cursor:default; }
input[type=text] { background:#0d1117; color:var(--text); border:1px solid
         #2a3644; border-radius:6px; padding:7px 10px; flex:1; min-width:220px; }
.bar { height:10px; background:#0d1117; border-radius:5px; overflow:hidden;
       margin:10px 0 4px; }
.bar > div { height:100%; width:0; background:var(--ok); transition:width .2s; }
.stats { display:grid; grid-template-columns:repeat(auto-fit,minmax(130px,1fr));
         gap:8px; margin-top:8px; }
.stat { background:#0d1117; border-radius:8px; padding:8px 10px; }
.stat b { display:block; font-size:16px; }
.stat span { color:var(--dim); font-size:12px; }
#logs { background:#0d1117; border-radius:8px; padding:10px; height:180px;
        overflow-y:auto; font:12px/1.5 ui-monospace, monospace;
        white-space:pre-wrap; }
#peers td { padding:3px 10px 3px 0; font:12px ui-monospace, monospace; }
#conn { width:9px; height:9px; border-radius:50%; display:inline-block;
        background:var(--err); margin-right:6px; }
#conn.on { background:var(--ok); }
.err { color:var(--err); }
</style>
</head>
<body>
<div class="wrap">
  <h1><span id="conn"></span>backuwup <small>peer-to-peer encrypted backup</small></h1>

  <div class="card">
    <div class="row">
      <input type="text" id="path" placeholder="backup path">
      <button class="secondary" id="save">Save path</button>
      <button id="backup">Back up</button>
      <button class="secondary" id="restore">Restore</button>
      <button class="secondary" id="audit">Audit peers</button>
    </div>
    <div class="bar"><div id="pbar"></div></div>
    <div class="row" style="justify-content:space-between">
      <span id="pfile" style="color:var(--dim)"></span>
      <span id="ppct"></span>
    </div>
    <div class="stats">
      <div class="stat"><b id="sdone">0</b><span>files done</span></div>
      <div class="stat"><b id="sfail">0</b><span>files failed</span></div>
      <div class="stat"><b id="swritten">0 B</b><span>packed on disk</span></div>
      <div class="stat"><b id="ssent">0 B</b><span>transmitted</span></div>
      <div class="stat"><b id="sspeed">-</b><span>transfer speed</span></div>
    </div>
  </div>

  <div class="card">
    <b>Peers</b>
    <table id="peers"></table>
  </div>

  <div class="card">
    <b>Log</b>
    <div id="logs"></div>
  </div>
</div>
<script>
"use strict";
const $ = id => document.getElementById(id);
let ws = null;
// rolling transfer-speed window (25 samples; static/app.js:44-58)
const speedSamples = [];
function fmtBytes(n) {
  if (!n) return "0 B";
  const u = ["B","KiB","MiB","GiB","TiB"];
  let i = 0; while (n >= 1024 && i < u.length-1) { n /= 1024; i++; }
  return n.toFixed(n >= 100 || i === 0 ? 0 : 1) + " " + u[i];
}
function logLine(text, cls) {
  const el = $("logs");
  const d = document.createElement("div");
  if (cls) d.className = cls;
  d.textContent = new Date().toLocaleTimeString() + "  " + text;
  el.appendChild(d);
  while (el.childElementCount > 500) el.removeChild(el.firstChild);
  el.scrollTop = el.scrollHeight;
}
function send(cmd, extra) {
  if (ws && ws.readyState === 1)
    ws.send(JSON.stringify(Object.assign({command: cmd}, extra || {})));
}
function onProgress(p) {
  $("pfile").textContent = p.current_file || "";
  $("sdone").textContent = p.files_done;
  $("sfail").textContent = p.files_failed;
  $("swritten").textContent = fmtBytes(p.bytes_on_disk);
  $("ssent").textContent = fmtBytes(p.bytes_transmitted);
  const pct = p.size_estimate > 0
    ? Math.min(100, 100 * p.bytes_on_disk / p.size_estimate) : 0;
  $("pbar").style.width = pct + "%";
  $("ppct").textContent = p.running ? pct.toFixed(0) + "%" : "";
  const now = Date.now() / 1000;
  speedSamples.push([now, p.bytes_transmitted]);
  while (speedSamples.length > 25) speedSamples.shift();
  if (speedSamples.length > 1) {
    const [t0, b0] = speedSamples[0], [t1, b1] = speedSamples.at(-1);
    $("sspeed").textContent =
      t1 > t0 ? fmtBytes((b1 - b0) / (t1 - t0)) + "/s" : "-";
  }
  $("backup").disabled = $("restore").disabled = !!p.running;
}
function auditLabel(a) {
  if (!a) return "-";
  const tally = a.passes + "/" + a.failures + "/" + a.misses;
  return a.health + " (" + tally + ")";
}
function onPeers(peers) {
  const t = $("peers");
  t.innerHTML = "<tr><td>peer</td><td>negotiated</td><td>sent</td>" +
                "<td>stored for them</td><td>audit p/f/m</td></tr>";
  for (const p of peers) {
    const r = t.insertRow();
    for (const v of [p.id.slice(0, 12), fmtBytes(p.negotiated),
                     fmtBytes(p.transmitted), fmtBytes(p.received)])
      r.insertCell().textContent = v;
    const c = r.insertCell();
    c.textContent = auditLabel(p.audit);
    if (p.audit && (p.audit.health === "demoted" ||
                    p.audit.health.startsWith("fail")))
      c.className = "err";
  }
}
function onEvent(ev) {
  if (ev.kind === "progress") onProgress(ev.payload);
  else if (ev.kind === "peers") onPeers(ev.payload.peers);
  else if (ev.kind === "config") $("path").value = ev.payload.backup_path || "";
  else if (ev.kind === "message") logLine(ev.payload.text);
  else if (ev.kind === "panic") logLine("PANIC: " + ev.payload.text, "err");
  else if (ev.kind === "backup_started") logLine("backup started");
  else if (ev.kind === "backup_finished")
    logLine("backup finished: " + ev.payload.snapshot);
  else if (ev.kind === "restore_started") logLine("restore started");
  else if (ev.kind === "restore_finished") logLine("restore finished");
  else if (ev.kind === "audit") {
    const a = ev.payload;
    logLine("audit " + a.outcome + " for " + a.peer.slice(0, 12) +
            (a.detail ? ": " + a.detail : "") +
            (a.demoted ? " [demoted]" : ""),
            a.outcome === "pass" ? undefined : "err");
  }
  else if (ev.kind === "error") logLine(ev.payload.text, "err");
}
function connect() {
  ws = new WebSocket((location.protocol === "https:" ? "wss://" : "ws://") +
                     location.host + "/ws");
  ws.onopen = () => { $("conn").classList.add("on"); send("get_config"); };
  ws.onmessage = m => onEvent(JSON.parse(m.data));
  ws.onclose = () => {          // auto-reconnect (static/app.js:131-140)
    $("conn").classList.remove("on");
    setTimeout(connect, 1000);
  };
}
$("save").onclick = () => send("config", {backup_path: $("path").value});
$("backup").onclick = () => send("start_backup");
$("restore").onclick = () => send("start_restore");
$("audit").onclick = () => send("start_audit");
connect();
</script>
</body>
</html>
"""
